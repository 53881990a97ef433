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
// ⊗ and one ⊕ FP32 instruction with no fused form and no tensor-core MMA,
// so it is bound by CUDA-core issue: 2*G*N^3 / (132 SMs * 128 lanes * SM
// clock) a solve, about 34 ms at N = 8192 and 1.98 GHz.  Its memory traffic,
// 2*N*N*4 bytes a round, is far below that.  The design keeps the update's
// fold in register micro-tiles (minplus_tile.cuh) so that shared-memory
// reads do not become the limit.
//
// Shared memory.  The TPU kernel closes the whole pivot in VMEM once per
// row stripe.  An f32 pivot at B = 256 is 256 KiB, more than the 227 KB a
// CTA may have, so the round is three grids on one stream:
//   1. fw_closure:  one CTA of 512 threads per graph closes its pivot
//      (close_tile, fw_closure.cuh, shared with fw_block.cu).  Each thread
//      holds its share of the B x B tile, half in registers and half in
//      shared memory; row k and column k pass through shared buffers
//      between barriers.  This grid is serial work on G CTAs while the
//      other SMs wait: it is the first thing a later change should overlap.
//   2. fw_colpanel: col' into a (G, N, B) f32 scratch with the tiled fold;
//      it also copies the pivot row panel into a (G, B, N) f32 scratch.
//   3. fw_update:   CTAs over (G, N/BM, N/BN) output tiles fold
//      col' ⊗ rowpanel over k = 0..B on top of D and write D in place.
// In-place hazard: grid 3 reads the row panel while the CTAs that own those
// rows overwrite them, so it reads the copy grid 2 made.  Scratch is
// G*(B*B + 2*N*B) floats (16 MiB at N = 8192, B = 256), against the second
// N x N buffer (256 MiB) that ping-pong would take.
//
// The wrapper (kernels/fw_round.py) checks shapes and allocates the scratch;
// everything launches on the caller's stream, and each launch's error is
// returned to it.
#include <cuda_runtime.h>

#include "fw_closure.cuh"
#include "minplus_tile.cuh"
#include "semiring.cuh"

namespace repro_torch {

constexpr int BM = 128, BN = 128, BK = 16, TM = 8, TN = 8;
using Shape = TileShape<BM, BN, BK, TM, TN>;

template <int SR, class T>
__global__ void __launch_bounds__(kCloseThreads, 1)
fw_closure(const T* __restrict__ d, float* __restrict__ apiv, int n, int b, int o) {
  extern __shared__ float4 smem4[];
  close_tile<SR, T>(d + (long long)blockIdx.x * n * n + (long long)o * n + o,
                    apiv + (long long)blockIdx.x * b * b, n, b, smem4);
}

template <int SR, class T>
__global__ void __launch_bounds__(Shape::kThreads)
fw_colpanel(const T* __restrict__ d, const float* __restrict__ apiv,
            float* __restrict__ colp, float* __restrict__ rowp, int n, int b, int o) {
  __shared__ __align__(16) float smem[Shape::kSmemFloats];
  const int g = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const T* dg = d + (long long)g * n * n;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int jj = 0; jj < TN; ++jj) acc[i][jj] = Semiring<SR>::zero();
  fold_tile<SR, BM, BN, BK, TM, TN>(acc, dg + o, n, apiv + (long long)g * b * b, b,
                                    m0, n0, n, b, b, smem);
  float* cg = colp + (long long)g * n * b;
  const int r0 = m0 + Shape::row(threadIdx.x), c0 = n0 + Shape::col(threadIdx.x);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int jj = 0; jj < TN; ++jj)
      if (r0 + i < n && c0 + jj < b)
        cg[(long long)(r0 + i) * b + c0 + jj] = Storage<T>::round(acc[i][jj]);

  // Columns m0..m0+BM of the pivot row panel, copied once per row tile.
  if (blockIdx.x == 0) {
    float* rg = rowp + (long long)g * b * n;
    for (int e = threadIdx.x; e < b * BM; e += Shape::kThreads) {
      const int r = e / BM, c = m0 + e % BM;
      if (c < n) rg[(long long)r * n + c] = Storage<T>::load(dg[(long long)(o + r) * n + c]);
    }
  }
}

// Two CTAs an SM (at most 128 registers a thread), so that one CTA's
// k-slice staging overlaps the other's fold.
template <int SR, class T>
__global__ void __launch_bounds__(Shape::kThreads, 2)
fw_update(T* __restrict__ d, const float* __restrict__ colp,
          const float* __restrict__ rowp, int n, int b) {
  __shared__ __align__(16) float smem[Shape::kSmemFloats];
  const int g = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  T* dg = d + (long long)g * n * n;
  const int r0 = m0 + Shape::row(threadIdx.x), c0 = n0 + Shape::col(threadIdx.x);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int jj = 0; jj < TN; ++jj)
      acc[i][jj] = (r0 + i < n && c0 + jj < n)
                       ? Storage<T>::load(dg[(long long)(r0 + i) * n + c0 + jj])
                       : Semiring<SR>::zero();
  fold_tile<SR, BM, BN, BK, TM, TN>(acc, colp + (long long)g * n * b, b,
                                    rowp + (long long)g * b * n, n, m0, n0, n, n, b, smem);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int jj = 0; jj < TN; ++jj)
      if (r0 + i < n && c0 + jj < n)
        dg[(long long)(r0 + i) * n + c0 + jj] = Storage<T>::store(acc[i][jj]);
}

template <int SR, class T>
cudaError_t launch_round(T* d, float* apiv, float* colp, float* rowp, int g, int n,
                         int b, int o, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fw_closure<SR, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kCloseSmemBytes);
  if (err != cudaSuccess) return err;
  fw_closure<SR, T><<<g, kCloseThreads, kCloseSmemBytes, stream>>>(d, apiv, n, b, o);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 panel((b + BN - 1) / BN, (n + BM - 1) / BM, g);
  fw_colpanel<SR, T><<<panel, Shape::kThreads, 0, stream>>>(d, apiv, colp, rowp, n, b, o);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 update((n + BN - 1) / BN, (n + BM - 1) / BM, g);
  fw_update<SR, T><<<update, Shape::kThreads, 0, stream>>>(d, colp, rowp, n, b);
  return cudaGetLastError();
}

template <class T>
cudaError_t dispatch(int semiring, void* d, void* apiv, void* colp, void* rowp, int g,
                     int n, int b, int o, cudaStream_t s) {
  T* dd = static_cast<T*>(d);
  float *a = static_cast<float*>(apiv), *c = static_cast<float*>(colp),
        *r = static_cast<float*>(rowp);
  switch (semiring) {
    case 0: return launch_round<0, T>(dd, a, c, r, g, n, b, o, s);
    case 1: return launch_round<1, T>(dd, a, c, r, g, n, b, o, s);
    case 2: return launch_round<2, T>(dd, a, c, r, g, n, b, o, s);
    case 3: return launch_round<3, T>(dd, a, c, r, g, n, b, o, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace repro_torch

// C interface for ctypes.  d: (g, n, n) contiguous storage, float32
// (bf16 == 0) or bf16 (bf16 == 1); apiv (g, b, b), colp (g, n, b) and rowp
// (g, b, n) are float32 scratch.  Returns a cudaError_t.
extern "C" int fw_round_launch(int semiring, int bf16, void* d, void* apiv, void* colp,
                               void* rowp, int g, int n, int b, int o, void* stream) {
  using namespace repro_torch;
  if (g < 1 || n < 1 || b < 1 || b > kCloseMaxB || n % b != 0 || o < 0 || o % b != 0 ||
      o >= n)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(semiring, d, apiv, colp, rowp, g, n, b, o, s)
              : dispatch<float>(semiring, d, apiv, colp, rowp, g, n, b, o, s);
}
