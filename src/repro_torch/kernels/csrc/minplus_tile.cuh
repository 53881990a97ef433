// The pipelined ⊕⊗ fold shared by the port's kernels (fw_round's fw_colpanel
// and fw_update, every product of minplus.cu, the three modes of
// row_close.cu).  One CTA folds
//   acc[i][j] = acc[i][j] ⊕ (⊕_k x[i][k] ⊗ y[k][j])
// over k = 0..K into a BM x BN output tile held as 8 x TN register
// micro-tiles, one per thread, with k staged through shared memory BK at a
// time.  It ports _minplus_body (src/repro/kernels/minplus.py:75): the same
// candidate set folded into the same accumulator, so with a selective ⊕ the
// bits match the TPU kernel and the plain version.
//
// (min, +) has no tensor-core instruction, so the fold runs on the CUDA
// cores: every candidate costs one ⊗ and one ⊕ instruction.  The 8 x TN
// micro-tile gives 8*TN candidates for 8 + TN shared-memory reads, which
// keeps the fold bound by those instructions rather than by shared memory.
#pragma once

#include <cstdint>

#include "semiring.cuh"

namespace repro_torch {

// Both operands arrive as k-major rows, so a k slice of either is BK
// straight row segments: xt (K x M, the left
// operand transposed, row pitch ldx) and y (K x N, row pitch ldy).  Each
// row is 16-byte aligned (base and pitch a multiple of 4 floats), and a row
// is read up to its column limit (nx, ny), a multiple of 4 that is at most
// the pitch.  A ring of STAGES shared-memory slices is filled by 16-byte
// cp.async copies, STAGES - 1 slices ahead of the fold, with one CTA barrier
// a slice.
//
// Thread t holds an 8 x TN micro-tile (TN = 8 or 4) as two runs of four rows
// (BM/2 apart) by two runs of four columns (BN/2 apart; one run when TN =
// 4), so the 16-byte shared reads of a k step touch consecutive addresses
// across the warp (no bank conflicts).  Rows k >= K are staged as the
// semiring zero, which adds nothing to a value fold and which the witness
// fold skips; columns past the limit are staged as 0 and never stored.
template <int BM, int BN, int BK, int STAGES, int TN = 8>
struct RingShape {
  static constexpr int TM = 8;
  static constexpr int kThreads = (BM / TM) * (BN / TN);
  static constexpr int kStageFloats = BK * (BM + BN);
  static constexpr int kSmemBytes = STAGES * kStageFloats * 4;
  static_assert(BM % 8 == 0 && BN % 8 == 0 && STAGES >= 2 && (TN == 8 || TN == 4),
                "ring tile shape");
  // Output coordinates of acc[i][j] for thread t: row m0 + row(t, i),
  // column n0 + col(t, j).
  static __device__ __forceinline__ int row(int t, int i) {
    return (i < 4 ? 0 : BM / 2) + (t / (BN / TN)) * 4 + (i & 3);
  }
  static __device__ __forceinline__ int col(int t, int j) {
    return (j < 4 ? 0 : BN / 2) + (t % (BN / TN)) * 4 + (j & 3);
  }
};

// The product tiles of minplus.cu and row_close.cu, one lattice: BM = 64,
// 32 or 16 rows at 128 threads of 8 x TN outputs (TN = 8 for values, 4
// with a witness).  The column tile widens as BM narrows (BM * BN = 8192
// outputs a CTA, 4096 with a witness), so a short row list wastes no
// thread on padded rows; the k slice is shallow enough that three ring
// slots of BK * (BM + BN) floats leave room for three CTAs an SM (with a
// witness, beside fold_ring's 16 KB of witness slots, at BM = 64 and 16;
// two at 32).  At BM = 64 these are fw_update's value tile (64 x 128, BK 32)
// and the witness tile (64 x 64, BK 32).
template <bool TRACK, int BM>
struct ProductTile {
  static constexpr int TN = TRACK ? 4 : 8;
  static constexpr int BN = 16 * TN * 64 / BM;
  static constexpr int BK = TRACK ? (BM < 32 ? BM : 32) : (BM / 2 < 32 ? BM / 2 : 32);
  static constexpr int STAGES = 3, kThreads = 128, kMinBlocks = 3;
  using Ring = RingShape<BM, BN, BK, STAGES, TN>;
  static_assert(BM == 16 || BM == 32 || BM == 64, "the tile lattice's rows");
  static_assert(Ring::kThreads == kThreads, "128 threads a CTA");
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Rows k0..k0+BK of src (pitch ld, W columns from c0, read below the column
// limit nc) into dst [BK][W], one 16-byte chunk a thread at a time (a slice
// of fewer chunks than threads leaves the last threads idle).
template <int SR, int W, int BK, int THREADS>
__device__ __forceinline__ void ring_copy(float* dst, const float* __restrict__ src,
                                          long long ld, long long nc, int c0, int k0, int K) {
  constexpr int kChunks = BK * W / 4;
  static_assert(kChunks % THREADS == 0 || kChunks < THREADS, "whole chunks a thread");
#pragma unroll
  for (int q = 0; q < (kChunks + THREADS - 1) / THREADS; ++q) {
    const int e = q * THREADS + threadIdx.x;
    if (kChunks < THREADS && e >= kChunks) break;
    const int r = e / (W / 4), c = (e % (W / 4)) * 4;
    float* to = dst + r * W + c;
    if (k0 + r < K && c0 + c < nc) {
      cp_async16(to, src + (long long)(k0 + r) * ld + c0 + c);
    } else {
      const float z = k0 + r < K ? 0.0f : Semiring<SR>::zero();
      *reinterpret_cast<float4*>(to) = make_float4(z, z, z, z);
    }
  }
}

// The witness fold's counts a launch, kept only where the kernel is given a
// buffer of kFoldCounts (the wrapper passes one while a profiler runs): warp
// slices folded, warp slices run eagerly, rescan passes (a deferred warp
// slice makes as many as its busiest lane has moved outputs), and outputs
// resolved.
enum : int { kSlices, kEager, kRescans, kResolved, kFoldCounts };

// A warp folds its next slice eagerly where one of its lanes had more than
// this many outputs move in the slice before.  A rescan pass costs a warp
// about 200 scheduler cycles, the deferred fold of a slice about 4100 and
// the eager fold about 7600 (PERF.md, at 8192 x 256 x 8192), so deferring
// pays up to about 16 passes.
constexpr int kMostRescans = 16;

// The witness fold's shared slots: one int a thread and output, register
// by register, so that a warp's accesses are consecutive.
template <int N>
__device__ __forceinline__ int* witness_slots() {
  __shared__ int slots[N];
  return slots;
}

// A shared store made only where p holds, predicated rather than branched
// around: a branch around a store in a warp's divergent lanes costs a
// reconvergence barrier.
__device__ __forceinline__ void store_if(bool p, int* at, int v) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(at));
  asm volatile("{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n @q st.shared.b32 [%0], %1;\n}"
               ::"r"(s), "r"(v), "r"(int(p)) : "memory");
}

__device__ __forceinline__ unsigned long long* fold_tally() {
  __shared__ unsigned long long tally[kFoldCounts];
  return tally;
}

// acc[i][j] = acc[i][j] ⊕ (⊕_k xt[k][m0 + row(t, i)] ⊗ y[k][n0 + col(t, j)])
// over k = 0..K.  With TRACK, the witness fold instead: in ascending k, a
// candidate that strictly improves (Semiring::better) replaces acc[i][j]
// and sets idx[i][j] to its k, so ties keep the smallest k and a NaN
// candidate never improves; idx is untouched where nothing improved, and
// padded k (>= K) is never a candidate.  Without TRACK, idx is not used.
//
// The witness fold takes each ring slice one of two ways, chosen a warp at a
// time.  Eager: each candidate against the accumulator (one ⊗, one compare,
// two selects; 4.55 instructions a candidate), the slice's winners kept
// beside acc and written to shared slots after the slice.  Deferred: the
// value loop (one ⊗ and one Semiring::pick a candidate, no index touched)
// folds the slice into a copy of acc, and an output needs its witness only
// where that slice value strictly improves on acc (better: false for NaN).
// Those outputs take the slice value, parked in their witness slot, and
// each lane then rescans the slice, still in its ring slot, once for each
// of its outputs that moved (the lanes of a warp side by side): the
// witness is the first k whose candidate, recomputed with the same ⊗,
// equals the slice value, and where that value is ±0 the accumulator takes
// the witness candidate's own bits.  That is the eager fold's (value, k)
// bit for bit, ties included.  A warp folds a slice eagerly where one of
// its lanes had more than kMostRescans outputs move in its previous slice,
// or, for the first slice, start at the semiring zero (every output of a
// fold from the zero: it improves nearly everywhere), and always a partial
// last slice.  idx lives in shared slots during the fold; stats, where not
// null, takes the counts (kFoldCounts) with one atomic add a count a CTA.
//
// smem holds RingShape::kSmemBytes; every thread of the CTA must call it
// (it synchronises the CTA).
template <int SR, int BM, int BN, int BK, int STAGES, int TN, bool TRACK>
__device__ __forceinline__ void fold_ring(float (&acc)[8][TN], int (&idx)[8][TN],
                                          const float* __restrict__ xt, long long ldx,
                                          long long nx, const float* __restrict__ y,
                                          long long ldy, long long ny, int m0, int n0, int K,
                                          float* smem, unsigned long long* stats = nullptr) {
  using S = Semiring<SR>;
  using R = RingShape<BM, BN, BK, STAGES, TN>;
  const int t = threadIdx.x;
  const int ty = (t / (BN / TN)) * 4, tx = (t % (BN / TN)) * 4;
  const int nk = (K + BK - 1) / BK;
  auto stage = [&](int slot, int k0) {
    float* s = smem + slot * R::kStageFloats;
    ring_copy<SR, BM, BK, R::kThreads>(s, xt, ldx, nx, m0, k0, K);
    ring_copy<SR, BN, BK, R::kThreads>(s + BK * BM, y, ldy, ny, n0, k0, K);
  };
  // The witness fold's state: idx's slots, the warp's way for its next
  // slice, its counts.
  [[maybe_unused]] int* slots = nullptr;
  [[maybe_unused]] bool eager = false;
  [[maybe_unused]] int counts[kFoldCounts] = {};
  if constexpr (TRACK) {
    static_assert(TN == 4, "the witness tile is 8 x 4 a thread");
    slots = witness_slots<8 * TN * R::kThreads>();
    int at_zero = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        slots[(i * TN + j) * R::kThreads + t] = idx[i][j];
        at_zero += acc[i][j] == S::zero();
      }
    eager = __reduce_max_sync(~0u, at_zero) > kMostRescans;
  }
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) stage(s, s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();             // slice kt landed; slice kt - 1's slot is free
    const int ahead = kt + STAGES - 1;
    if (ahead < nk) stage(ahead % STAGES, ahead * BK);
    cp_async_commit();
    const float* sx = smem + (kt % STAGES) * R::kStageFloats;
    const float* sy = sx + BK * BM;
    const int k0 = kt * BK;
    [[maybe_unused]] int won[8][TN];  // an eager slice's winners, k within the slice
    auto fold_step = [&](int kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&sx[kk * BM + ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&sx[kk * BM + BM / 2 + ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&sy[kk * BN + tx]);
      float4 b1 = b0;
      if constexpr (TN == 8)
        b1 = *reinterpret_cast<const float4*>(&sy[kk * BN + BN / 2 + tx]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          if constexpr (TRACK) {
            const float c = S::mul(a[i], b[j]);
            if (S::better(c, acc[i][j])) {
              acc[i][j] = c;
              won[i][j] = kk;
            }
          } else {
            acc[i][j] = S::add(acc[i][j], S::mul(a[i], b[j]));
          }
        }
    };
    if constexpr (TRACK) {
      int mine = 0;  // this lane's outputs whose witness moved in this slice
      const bool deferred = !eager && k0 + BK <= K;
      if (!deferred) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) won[i][j] = -1;
        if (k0 + BK <= K) {
#pragma unroll 8
          for (int kk = 0; kk < BK; ++kk) fold_step(kk);
        } else {
          // The last, partial slice: padded k is no candidate.
          for (int kk = 0; kk < K - k0; ++kk) fold_step(kk);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            store_if(won[i][j] >= 0, &slots[(i * TN + j) * R::kThreads + t], k0 + won[i][j]);
            mine += won[i][j] >= 0;
          }
        ++counts[kEager];
      } else {
        float v[8][TN];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) v[i][j] = acc[i][j];
#pragma unroll 8
        for (int kk = 0; kk < BK; ++kk) {
          const float4 a0 = *reinterpret_cast<const float4*>(&sx[kk * BM + ty]);
          const float4 a1 = *reinterpret_cast<const float4*>(&sx[kk * BM + BM / 2 + ty]);
          const float4 b0 = *reinterpret_cast<const float4*>(&sy[kk * BN + tx]);
          const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float b[4] = {b0.x, b0.y, b0.z, b0.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) v[i][j] = S::pick(v[i][j], S::mul(a[i], b[j]));
        }
        // Moved outputs take the slice value and park it in their slot.
        unsigned left = 0;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            const bool up = S::better(v[i][j], acc[i][j]);
            acc[i][j] = up ? v[i][j] : acc[i][j];
            store_if(up, &slots[(i * TN + j) * R::kThreads + t], __float_as_int(v[i][j]));
            left |= unsigned(up) << (i * TN + j);
          }
        mine = __popc(left);
        counts[kResolved] += mine;
        // Each lane rescans the slice for each of its moved outputs.
        unsigned signed_zero = 0;
        while (left) {
          const int r = __ffs(left) - 1;
          left &= left - 1;
          const int i = r / TN, j = r % TN;
          const int row = (i < 4 ? 0 : BM / 2) + ty + (i & 3);
          const int col = (j < 4 ? 0 : BN / 2) + tx + (j & 3);
          int* const at = &slots[r * R::kThreads + t];
          const float want = __int_as_float(*at);
          int kw = 0;
#pragma unroll
          for (int kk = BK - 1; kk >= 0; --kk)
            if (S::mul(sx[kk * BM + row], sy[kk * BN + col]) == want) kw = kk;
          *at = k0 + kw;
          signed_zero |= unsigned(want == 0.0f) << r;
        }
        // A slice value of ±0: the witness candidate's own sign.
        if (signed_zero) {
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j)
              if (signed_zero >> (i * TN + j) & 1) {
                const int kk = slots[(i * TN + j) * R::kThreads + t] - k0;
                acc[i][j] = S::mul(sx[kk * BM + R::row(t, i)], sy[kk * BN + R::col(t, j)]);
              }
        }
      }
      const int most = __reduce_max_sync(~0u, mine);
      counts[kRescans] += deferred ? most : 0;
      eager = most > kMostRescans;
    } else {
      // Unrolled by 8, not by BK: fully unrolled at BK = 32 the loop spills.
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) fold_step(kk);
    }
  }
  cp_async_wait<0>();
  if constexpr (TRACK) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) idx[i][j] = slots[(i * TN + j) * R::kThreads + t];
    if (stats) {
      unsigned long long* tally = fold_tally();
      if (t < kFoldCounts) tally[t] = 0;
      counts[kSlices] = nk;
      counts[kResolved] = __reduce_add_sync(~0u, counts[kResolved]);
      __syncthreads();
      if ((t & 31) == 0) {
#pragma unroll
        for (int c = 0; c < kFoldCounts; ++c)
          if (counts[c]) atomicAdd(&tally[c], (unsigned long long)counts[c]);
      }
      __syncthreads();
      if (t < kFoldCounts && tally[t]) atomicAdd(&stats[t], tally[t]);
    }
  }
}

// The value fold of fw_colpanel and fw_update: both operands read up to
// their pitch.
template <int SR, int BM, int BN, int BK, int STAGES>
__device__ __forceinline__ void fold_ring(float (&acc)[8][8], const float* __restrict__ xt,
                                          long long ldx, const float* __restrict__ y,
                                          long long ldy, int m0, int n0, int K, float* smem) {
  int unused[8][8];
  fold_ring<SR, BM, BN, BK, STAGES, 8, false>(acc, unused, xt, ldx, ldx, y, ldy, ldy, m0, n0,
                                              K, smem);
}

// Split k, shared by minplus.cu (minplus_chunk, minplus_combine) and
// row_close.cu (its chunks and row_close_merge).  Chunk q of a plane of
// `plane` outputs keeps output e's partial at pz[q * plane + e] and, for a
// witness, its global k (-1 when no k of the chunk won) at pk.  The fold
// back walks the chunks in ascending order, ⊕ for values and the strict
// improvement for a witness, so a tie keeps the smallest k as the unsplit
// fold does; the caller gives the start value and finishes the output.
template <bool TRACK>
__device__ __forceinline__ void store_partial(float* __restrict__ pz, int* __restrict__ pk,
                                              long long plane, int q, long long e, float v,
                                              int k) {
  pz[q * plane + e] = v;
  if constexpr (TRACK) pk[q * plane + e] = k;
}

template <int SR, bool TRACK>
__device__ __forceinline__ void fold_partials(const float* __restrict__ pz,
                                              const int* __restrict__ pk, long long plane,
                                              long long e, int chunks, float& v, int& k) {
  using S = Semiring<SR>;
  for (int q = 0; q < chunks; ++q) {
    const float p = pz[q * plane + e];
    if constexpr (!TRACK) {
      v = S::add(v, p);
    } else if (S::better(p, v)) {
      v = p;
      k = pk[q * plane + e];
    }
  }
}

}  // namespace repro_torch
