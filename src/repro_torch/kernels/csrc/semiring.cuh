// The four built-in closed semirings of repro_torch.core.semiring, as device
// functors, plus the storage types the kernels take.
//
// Semiring codes (the wrappers in kernels/*.py pass them):
//   0 tropical     ⊕ = min, ⊗ = +,   zero = +inf
//   1 bottleneck   ⊕ = max, ⊗ = min, zero = -inf
//   2 reliability  ⊕ = max, ⊗ = ×,   zero = 0
//   3 boolean      ⊕ = max, ⊗ = min, zero = 0
//
// min and max propagate NaN, as torch.minimum and jnp.minimum do.  fminf and
// fmaxf return the other operand instead, so a NaN that reached a kernel
// under validate=False would vanish on the card and stay on the CPU; the
// PTX min.NaN / max.NaN instructions (sm_80 and later) are one instruction
// each and keep it.  Each candidate x ⊗ y is one rounded operation and ⊕ is
// selective, so any fold order over the same candidates gives the same bits
// as the plain version.  Build without --use_fast_math and -ftz=true: a
// flushed subnormal would change the reliability semiring's products.
//
// better(c, acc) is the strict improvement of the witness folds (< for a
// min ⊕, > for a max ⊕).  A comparison with NaN is false, so a NaN
// candidate never improves and a NaN accumulator is never replaced: the
// port's NaN rule for witnesses, with no extra instruction.
//
// pick(a, b) is ⊕ that ignores NaN (fminf / fmaxf: FMNMX without .NaN, one
// instruction): the deferred witness fold's slice value, in which a NaN
// candidate never wins, as under better.
#pragma once

#include <cuda_bf16.h>
#include <math_constants.h>

namespace repro_torch {

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

template <int SR> struct Semiring;

template <> struct Semiring<0> {  // tropical
  static __device__ __forceinline__ float zero() { return CUDART_INF_F; }
  static __device__ __forceinline__ float add(float a, float b) { return min_nan(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ bool better(float c, float acc) { return c < acc; }
  static __device__ __forceinline__ float pick(float a, float b) { return fminf(a, b); }
};

template <> struct Semiring<1> {  // bottleneck
  static __device__ __forceinline__ float zero() { return -CUDART_INF_F; }
  static __device__ __forceinline__ float add(float a, float b) { return max_nan(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return min_nan(a, b); }
  static __device__ __forceinline__ bool better(float c, float acc) { return c > acc; }
  static __device__ __forceinline__ float pick(float a, float b) { return fmaxf(a, b); }
};

template <> struct Semiring<2> {  // reliability
  static __device__ __forceinline__ float zero() { return 0.0f; }
  static __device__ __forceinline__ float add(float a, float b) { return max_nan(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ bool better(float c, float acc) { return c > acc; }
  static __device__ __forceinline__ float pick(float a, float b) { return fmaxf(a, b); }
};

template <> struct Semiring<3> {  // boolean
  static __device__ __forceinline__ float zero() { return 0.0f; }
  static __device__ __forceinline__ float add(float a, float b) { return max_nan(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return min_nan(a, b); }
  static __device__ __forceinline__ bool better(float c, float acc) { return c > acc; }
  static __device__ __forceinline__ float pick(float a, float b) { return fmaxf(a, b); }
};

// Storage: float32, or bf16 with float32 arithmetic.  round() is the value a
// float takes after a trip through the storage type (the bf16 rounding
// points of the round: closed pivot, col', output).
template <class T> struct Storage;

template <> struct Storage<float> {
  static __device__ __forceinline__ float load(float v) { return v; }
  static __device__ __forceinline__ float store(float v) { return v; }
  static __device__ __forceinline__ float round(float v) { return v; }
};

template <> struct Storage<__nv_bfloat16> {
  static __device__ __forceinline__ float load(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ __nv_bfloat16 store(float v) { return __float2bfloat16_rn(v); }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

}  // namespace repro_torch
