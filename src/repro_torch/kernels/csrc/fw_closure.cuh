// The B x B pivot closure shared by fw_round.cu (stage 1 of the fused
// round) and fw_block.cu (the split round's stage 1):
//   for k in 0..B:  A <- A ⊕ A[:, k] ⊗ A[k, :]
// B sequential rank-1 ⊕⊗ steps on one CTA of 512 threads.  An f32 tile at
// B = 256 is 256 KiB, more than the 227 KB a CTA may have, so each thread
// holds its share half in registers and half in shared memory; row k and
// column k pass through shared buffers between barriers.
#pragma once

#include "semiring.cuh"

namespace repro_torch {

constexpr int kCloseThreads = 512;
constexpr int kCloseMaxB = 256;
// Thread t owns column j = t % B of the rows i0 + r * groups, where
// groups = 512 / B and i0 = t / B: at most 128 rows for B <= 256.  The
// tile (256 KiB at B = 256) is as large as the register file, so a thread
// keeps kCloseRegRows of its rows in registers and the rest in shared
// memory, four rows to a float4.
// Column k is published in a permuted layout, each i0's rows contiguous,
// so that a thread reads the column values of its rows four at a time.
constexpr int kCloseMaxRows = 128;
constexpr int kCloseRegRows = 64;
constexpr int kCloseShQuads = (kCloseMaxRows - kCloseRegRows) / 4;
// i0 * rp + r over all threads, rp = rows a thread rounded up to 4: at
// most B + 4 * groups <= 2049 floats.
constexpr int kCloseColFloats = 2560;
constexpr size_t kCloseSmemBytes =
    (kCloseMaxB + kCloseColFloats) * sizeof(float) +
    kCloseShQuads * kCloseThreads * sizeof(float4);

// v[r] for a run-time r, by a branch tree (registers cannot be indexed).
template <int LO, int HI, int N>
__device__ __forceinline__ float pick(const float (&v)[N], int r) {
  if constexpr (HI - LO == 1) {
    return v[LO];
  } else {
    constexpr int MID = (LO + HI) / 2;
    if (r < MID) return pick<LO, MID>(v, r);
    return pick<MID, HI>(v, r);
  }
}

// Close the b x b tile at dg (row stride n) into ag (b x b, row stride b),
// rounded through the storage type.  One CTA of kCloseThreads threads, with
// kCloseSmemBytes of dynamic shared memory at smem4.
template <int SR, class T>
__device__ __forceinline__ void close_tile(const T* __restrict__ dg, float* __restrict__ ag,
                                           int n, int b, float4* smem4) {
  using S = Semiring<SR>;
  float* srow = reinterpret_cast<float*>(smem4);     // row k of the tile
  float* scol = srow + kCloseMaxB;                   // column k, permuted
  float4* spart = reinterpret_cast<float4*>(scol + kCloseColFloats);  // [quad][thread]
  const int t = threadIdx.x;
  const int groups = kCloseThreads / b;
  const int j = t % b;
  const int i0 = t / b;
  const int nr = i0 < groups ? (b - i0 + groups - 1) / groups : 0;
  const int rp = ((b + groups - 1) / groups + 3) & ~3;
  float* mycol = scol + i0 * rp;                     // column k at my rows
  auto load = [&](int r) {
    return r < nr ? Storage<T>::load(dg[(long long)(i0 + r * groups) * n + j]) : S::zero();
  };

  float v[kCloseRegRows];
#pragma unroll
  for (int r = 0; r < kCloseRegRows; ++r) v[r] = load(r);
#pragma unroll
  for (int q = 0; q < kCloseShQuads; ++q) {
    const int r = kCloseRegRows + 4 * q;
    if (r < nr)
      spart[q * kCloseThreads + t] = make_float4(load(r), load(r + 1), load(r + 2), load(r + 3));
  }

  for (int k = 0; k < b; ++k) {
    if (j == k) {
#pragma unroll
      for (int q = 0; q < kCloseRegRows / 4; ++q)
        if (4 * q < nr)
          *reinterpret_cast<float4*>(&mycol[4 * q]) =
              make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
#pragma unroll
      for (int q = 0; q < kCloseShQuads; ++q)
        if (kCloseRegRows + 4 * q < nr)
          *reinterpret_cast<float4*>(&mycol[kCloseRegRows + 4 * q]) = spart[q * kCloseThreads + t];
    }
    const int kr = k - i0;
    if (nr > 0 && kr >= 0 && kr % groups == 0) {
      const int rk = kr / groups;
      srow[j] = rk < kCloseRegRows
                    ? pick<0, kCloseRegRows>(v, rk)
                    : reinterpret_cast<const float*>(
                          &spart[((rk - kCloseRegRows) / 4) * kCloseThreads + t])[(rk - kCloseRegRows) % 4];
    }
    __syncthreads();
    const float rj = srow[j];
#pragma unroll
    for (int q = 0; q < kCloseRegRows / 4; ++q) {
      if (4 * q < nr) {
        const float4 c = *reinterpret_cast<const float4*>(&mycol[4 * q]);
        v[4 * q] = S::add(v[4 * q], S::mul(c.x, rj));
        v[4 * q + 1] = S::add(v[4 * q + 1], S::mul(c.y, rj));
        v[4 * q + 2] = S::add(v[4 * q + 2], S::mul(c.z, rj));
        v[4 * q + 3] = S::add(v[4 * q + 3], S::mul(c.w, rj));
      }
    }
#pragma unroll
    for (int q = 0; q < kCloseShQuads; ++q) {
      if (kCloseRegRows + 4 * q < nr) {
        const float4 c = *reinterpret_cast<const float4*>(&mycol[kCloseRegRows + 4 * q]);
        float4 x = spart[q * kCloseThreads + t];
        x.x = S::add(x.x, S::mul(c.x, rj));
        x.y = S::add(x.y, S::mul(c.y, rj));
        x.z = S::add(x.z, S::mul(c.z, rj));
        x.w = S::add(x.w, S::mul(c.w, rj));
        spart[q * kCloseThreads + t] = x;
      }
    }
    __syncthreads();
  }

  ag += j;
#pragma unroll
  for (int r = 0; r < kCloseRegRows; ++r)
    if (r < nr) ag[(i0 + r * groups) * b] = Storage<T>::round(v[r]);
#pragma unroll
  for (int q = 0; q < kCloseShQuads; ++q) {
    const float4 x = spart[q * kCloseThreads + t];
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const int r = kCloseRegRows + 4 * q + l;
      if (r < nr) ag[(i0 + r * groups) * b] = Storage<T>::round(xs[l]);
    }
  }
}

}  // namespace repro_torch
