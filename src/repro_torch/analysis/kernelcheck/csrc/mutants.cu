// Seeded-defect tile kernels for the grid verifier on the card: proof that
// verify_case_cuda's canary and comparison catch what they claim to.
//
// A mini tropical (min, +) product Z = X ⊗ Y of (M, K) x (K, N) float32,
// one 16 x 16 output tile a CTA of 16 x 16 threads, one output a thread,
// k staged through shared memory 8 at a time.  Like a Pallas kernel that
// revisits its output block along k, each slice folds into Z in global
// memory, so the init of Z is what the defects break.  It is the
// counterpart of the JAX package's seeded-defect pallas_calls
// (src/repro/analysis/kernelcheck/mutants.py:92 and :137), a test fixture
// and no kernel of the system.  DEFECT:
//   0 control       Z set to the semiring zero before the first slice
//   1 dropped init  Z never set: the first slice folds into whatever the
//                   buffer held (the caller's canary, NaN, survives)
//   2 ungated init  Z reset before every slice: only the last slice counts
//   3 zero padding  k past K staged as 0.0 in place of +inf: on K not a
//                   multiple of 8 the padded candidates 0 + 0 win
#include <cuda_runtime.h>

#include <math_constants.h>

namespace {

constexpr int kTile = 16, kDepth = 8;

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

template <int DEFECT>
__global__ void __launch_bounds__(kTile * kTile)
mini_minplus(const float* __restrict__ x, const float* __restrict__ y, float* __restrict__ z,
             int m, int k, int n) {
  __shared__ float xs[kTile][kDepth];
  __shared__ float ys[kDepth][kTile];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int r = blockIdx.y * kTile + ty, c = blockIdx.x * kTile + tx;
  const bool mine = r < m && c < n;
  const float pad = DEFECT == 3 ? 0.0f : CUDART_INF_F;
  const int nk = (k + kDepth - 1) / kDepth;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kDepth;
    if (tx < kDepth) xs[ty][tx] = (r < m && k0 + tx < k) ? x[(long long)r * k + k0 + tx] : pad;
    if (ty < kDepth) ys[ty][tx] = (c < n && k0 + ty < k) ? y[(long long)(k0 + ty) * n + c] : pad;
    __syncthreads();
    if (mine && (DEFECT == 2 || (DEFECT != 1 && kt == 0))) z[(long long)r * n + c] = CUDART_INF_F;
    if (mine) {
      float acc = z[(long long)r * n + c];
      for (int kk = 0; kk < kDepth; ++kk) acc = min_nan(acc, xs[ty][kk] + ys[kk][tx]);
      z[(long long)r * n + c] = acc;
    }
    __syncthreads();
  }
}

template <int DEFECT>
cudaError_t run(const float* x, const float* y, float* z, int m, int k, int n,
                cudaStream_t s) {
  const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile);
  mini_minplus<DEFECT><<<grid, dim3(kTile, kTile), 0, s>>>(x, y, z, m, k, n);
  return cudaGetLastError();
}

}  // namespace

// C interface for ctypes: x (m, k), y (k, n) and z (m, n) contiguous
// float32 on the card, m, n >= 1, k >= 1.  Returns a cudaError_t.
extern "C" int mutant_launch(int defect, const void* x, const void* y, void* z, int m, int k,
                             int n, void* stream) {
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  float* zf = static_cast<float*>(z);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 1 || n < 1 || k < 1 || !x || !y || !z) return cudaErrorInvalidValue;
  switch (defect) {
    case 0: return run<0>(xf, yf, zf, m, k, n, s);
    case 1: return run<1>(xf, yf, zf, m, k, n, s);
    case 2: return run<2>(xf, yf, zf, m, k, n, s);
    case 3: return run<3>(xf, yf, zf, m, k, n, s);
    default: return cudaErrorInvalidValue;
  }
}
