// The B x B tile closure of the port, on one thread-block cluster:
//   for k in 0..B:  A <- A ⊕ A[:, k] ⊗ A[k, :]
// shared by fw_round.cu (stage 1 of the fused round, fw_closure) and
// fw_block.cu (fw_block, the split round's stage 1, and fw_block_pred).
//
// It replaces a closure that ran on one CTA of one SM (0.74 ms a
// tile at B = 256 on an H100, each of the B steps two CTA barriers and a branch-tree
// pick of row k out of registers; fw_block_pred kept its tile in global
// memory and moved B^2 values through one SM's share of L2 a step).
//
// Layout.  A cluster of C CTAs (C = 8, the portable maximum) closes one
// tile.  CTA c owns rows [c*R, min(B, c*R + R)), R = ceil(B/C) rounded up
// to a multiple of Q = kCloseStep (<= 32), and thread j of it owns column j
// of those rows: R values (and R preds) in registers, so the tile stays on
// chip from the first load to the final store.  Registers, not shared
// memory, hold it: a step then costs R candidates a thread and no
// shared-memory traffic for the tile itself.  CTAs that own no rows (small
// B, or B not a multiple of C*Q) still take part in every barrier.
//
// Q pivots a cluster barrier.  A cluster barrier costs about 1500 cycles on an H100
// (PERF.md: a one-pivot-a-barrier design spent 0.19 of its 0.25 ms a
// tile in barriers), so each barrier carries the Q pivots k0..k0+Q, which
// one CTA owns.  Every step still reads the old row and column of its
// pivot, as the JAX step does (src/repro/kernels/fw_block.py:79-91; under
// a tropical negative cycle step k rewrites both), and every element goes
// through exactly the sequential steps' operations in their order, so the
// bits are those of the plain version:
//   * before the barrier, the threads of columns k0..k0+Q publish this
//     CTA's rows of those columns (old) into a slot of its shared memory;
//     the owner steps its Q pivot rows through the Q steps among
//     themselves (Q - 1 CTA barriers, each broadcasting one column's
//     coefficients) and publishes rows k0+t as steps k0..k0+t-1 leave them
//     (values, and preds) into a slot of its own;
//   * one cluster barrier (barrier.cluster.arrive = release, wait =
//     acquire) makes both visible;
//   * each thread reads its elements of the Q published rows from the
//     owner through distributed shared memory (mapa + ld.shared::cluster);
//     the warp of columns k0..k0+Q steps this CTA's Q columns through the
//     Q pivots (lane r for row r, the pivot-block elements by shuffle) and
//     shares them after one CTA barrier; every thread then applies the Q
//     steps to its R values.
// The slots are double-buffered by the parity of the super-step: a CTA that
// publishes super-step m+1 has passed the barrier of m, so every CTA has
// finished reading the slots of m-1.  After the last one more cluster
// barrier keeps every CTA alive until no other CTA can read its slots.
//
// What bounds it.  A closure is a chain of B dependent steps: each waits for
// the row that the step before it finished.  Its card-wide operations
// bound (B^3 candidates over 132 SMs) cannot be reached; B/Q super-steps
// each cost one cluster barrier, one DSMEM read a published row and Q*R
// candidates a thread.
//
// Tiles above kCloseMaxB nodes (the reference takes any B that divides the
// padded N; its own cells use 512 and 1024) close on grid_close instead,
// further down: one cooperative launch of at most one CTA an SM, the tile
// in global memory (1 MiB at B = 512 and 4 MiB at 1024, twice that with
// preds, so it stays in the 50 MB L2), one grid barrier a pivot step.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "semiring.cuh"

namespace repro_torch {

constexpr int kCloseMaxB = 256;          // the largest tile of the cluster closure
constexpr int kClusterMax = 8;          // the portable cluster size
constexpr int kCloseMaxRows = 32;       // ceil(kCloseMaxB / kClusterMax)
constexpr int kCloseStep = 8;           // pivots a cluster barrier

// Dynamic shared memory of one CTA: the old column slots [2][Q][32], the
// stepped columns [Q][32], the pivot-row coefficients [Q][Q], the row slots [2][Q][b]
// and, with preds, the pred slots [2][Q][b] (Q = kCloseStep).
__host__ __device__ constexpr int close_smem_bytes(int b, bool pred) {
  return 4 * (3 * kCloseStep * kCloseMaxRows + kCloseStep * kCloseStep +
              2 * kCloseStep * b * (pred ? 2 : 1));
}

// A launch plan (computed by the Python wrapper, kernels/fw_block.py
// closure_plan) that this closure can run: every row owned, R rows in
// registers in whole groups of Q pivots, one thread a column, the slots
// inside the shared bytes.
__host__ __device__ inline bool close_plan_ok(int b, bool pred, int cluster, int rows,
                                              int threads, int shared) {
  return b >= 1 && b <= kCloseMaxB && cluster >= 1 && cluster <= kClusterMax &&
         rows >= 1 && rows <= kCloseMaxRows && rows % kCloseStep == 0 &&
         cluster * rows >= b && threads >= b &&
         threads <= kCloseMaxB && threads % 32 == 0 && shared >= close_smem_bytes(b, pred) &&
         shared <= 232448;
}

// The cluster size (%cluster_nctarank) of the latest launch of a closure
// without (index 0) and with (1) preds, as the hardware reports it to the
// grid's first thread at its end: a record of the launch that the smoke
// reads back through cluster_ctas_seen, one store a launch.
__device__ int g_closure_cluster[2];

// The recorded cluster size of the closure with or without preds, set back
// to 0 (0: none launched since the last read); a negative cudaError_t if
// the copy fails.  Synchronous: for checks and measurements, not the path.
inline int cluster_ctas_seen(bool pred) {
  int seen[2] = {0, 0};
  const int zero = 0;
  cudaError_t err = cudaMemcpyFromSymbol(seen, g_closure_cluster, sizeof seen);
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(g_closure_cluster, &zero, sizeof zero, pred ? sizeof zero : 0);
  return err == cudaSuccess ? seen[pred ? 1 : 0] : -static_cast<int>(err);
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_size() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}

// barrier.cluster.arrive has release and barrier.cluster.wait acquire
// semantics at cluster scope by default.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;" ::: "memory");
}

// The 32-bit word at `local` (a shared-memory address of this CTA) in the
// shared memory of CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t ld_cluster_b32(const void* local, unsigned rank) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(local));
  uint32_t remote, v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(a), "r"(rank));
  asm volatile("ld.shared::cluster.b32 %0, [%1];" : "=r"(v) : "r"(remote) : "memory");
  return v;
}

// One pivot step k applied to an element: x <- x ⊕ a ⊗ b with a from column
// k and b from row k, as the JAX step does it: ⊕ itself without preds
// (NaN propagates), a strict-improvement select with preds (px <- pb).
template <int SR, bool PRED>
__device__ __forceinline__ void relax(float& x, int& px, float a, float b, int pb) {
  using S = Semiring<SR>;
  const float via = S::mul(a, b);
  if constexpr (PRED) {
    const bool up = S::better(via, x);
    x = up ? via : x;
    px = up ? pb : px;
  } else {
    x = S::add(x, via);
  }
}

template <int SR, bool PRED>
__device__ __forceinline__ float relaxed(float x, float a, float b) {
  int unused = 0;
  relax<SR, PRED>(x, unused, a, b, 0);
  return x;
}

// Close tile number blockIdx.x / C: b x b at dg (row stride ld, storage T),
// with int32 preds at pg (row stride b) when PRED.  Writes the closed tile
// to out (b x b, row stride b), rounded through the storage type, and the
// preds to pout.  `rows` is R of the launch plan (a multiple of
// kCloseStep); the cluster is C CTAs of blockDim.x >= b threads with
// close_smem_bytes(b, PRED) of dynamic shared memory at smem.  Every thread
// of the cluster must call it.
template <int SR, bool PRED, class T>
__device__ __forceinline__ void cluster_close(const T* __restrict__ dg, long long ld,
                                              const int* __restrict__ pg,
                                              float* __restrict__ out, int* __restrict__ pout,
                                              int b, int rows, float* smem) {
  using S = Semiring<SR>;
  constexpr int Q = kCloseStep, MR = kCloseMaxRows;
  const unsigned rank = cluster_rank();
  const int csize = static_cast<int>(cluster_size());
  const int j = threadIdx.x;
  const int lane = j & 31;
  const bool mine = j < b;                              // a column of the tile
  const int r0 = static_cast<int>(rank) * rows;
  const int nr = max(0, min(b - r0, rows));             // rows this CTA owns
  float* colv = smem;                                   // [2][Q][MR] old columns
  float* colr = colv + 2 * Q * MR;                      // [Q][MR] stepped columns
  float* coef = colr + Q * MR;                          // [Q][Q] pivot-row coefficients
  float* rowv = coef + Q * Q;                           // [2][Q][b] stepped rows
  int* rowp = reinterpret_cast<int*>(rowv + 2 * Q * b); // [2][Q][b], PRED only

  // Rows past nr hold the zero and are folded like the others, but never
  // published or stored.
  float v[MR];
  int p[PRED ? MR : 1];
#pragma unroll
  for (int r = 0; r < MR; ++r) {
    const bool in = mine && r < nr;
    v[r] = in ? Storage<T>::load(dg[(long long)(r0 + r) * ld + j]) : S::zero();
    if constexpr (PRED) p[r] = in ? pg[(long long)(r0 + r) * b + j] : -1;
  }

  int m = 0;                                            // super-step
  for (int kc = 0; kc < csize; ++kc) {
    // rk0, the owner's local row of pivot k0, is a constant in each
    // unrolled copy, so v[rk0 + t] is a register, not a run-time index.
#pragma unroll
    for (int rk0 = 0; rk0 < MR; rk0 += Q) {
      const int k0 = kc * rows + rk0;
      if (rk0 < rows && k0 < b) {
        const int s = min(Q, b - k0);                   // pivots k0..k0+s
        const int buf = m & 1;
        const int t0 = j - k0;
        // The old columns k0..k0+Q of this CTA's rows, from their threads.
        if (t0 >= 0 && t0 < Q) {
#pragma unroll
          for (int q = 0; q < MR / 4; ++q)
            *reinterpret_cast<float4*>(&colv[(buf * Q + t0) * MR + 4 * q]) =
                make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
        }
        // The owner publishes rows k0+t as steps k0..k0+t-1 leave them:
        // step k0+t' of row k0+t takes its coefficient, the row's element
        // in column k0+t' after t' steps, from the thread of that column.
        if (static_cast<int>(rank) == kc) {
          float x[Q];
          int px[Q];
#pragma unroll
          for (int t = 0; t < Q; ++t) {
            x[t] = v[rk0 + t];
            if constexpr (PRED) px[t] = p[rk0 + t];
            else px[t] = 0;
          }
#pragma unroll
          for (int tp = 0; tp < Q - 1; ++tp) {
            if (t0 == tp) {
#pragma unroll
              for (int t = tp + 1; t < Q; ++t) coef[tp * Q + t] = x[t];
            }
            __syncthreads();
#pragma unroll
            for (int t = tp + 1; t < Q; ++t) relax<SR, PRED>(x[t], px[t], coef[tp * Q + t], x[tp], px[tp]);
          }
          if (mine) {
#pragma unroll
            for (int t = 0; t < Q; ++t) {
              if (t < s) {
                rowv[(buf * Q + t) * b + j] = x[t];
                if constexpr (PRED) rowp[(buf * Q + t) * b + j] = px[t];
              }
            }
          }
        }
        cluster_arrive();
        cluster_wait();
        // Rows k0..k0+s from the owner, through distributed shared memory.
        float P[Q];
        int PP[Q];
#pragma unroll
        for (int t = 0; t < Q; ++t) {
          P[t] = S::zero();
          PP[t] = -1;
          if (mine && t < s) {
            P[t] = __uint_as_float(ld_cluster_b32(&rowv[(buf * Q + t) * b + j], kc));
            if constexpr (PRED)
              PP[t] = static_cast<int>(ld_cluster_b32(&rowp[(buf * Q + t) * b + j], kc));
          }
        }
        // The warp that holds columns k0..k0+Q steps this CTA's column
        // values through them, lane r for row r; A[k0+t'][k0+t] after t'
        // steps is P[t'] of lane k0+t.
        if (j / 32 == k0 / 32) {
          float y[Q];
#pragma unroll
          for (int t = 0; t < Q; ++t) {
            y[t] = colv[(buf * Q + t) * MR + lane];
#pragma unroll
            for (int tp = 0; tp < t; ++tp)
              y[t] = relaxed<SR, PRED>(y[t], y[tp], __shfl_sync(0xffffffffu, P[tp], (k0 & 31) + t));
            colr[t * MR + lane] = y[t];
          }
        }
        __syncthreads();
#pragma unroll
        for (int t = 0; t < Q; ++t) {
          if (t < s) {
#pragma unroll
            for (int q = 0; q < MR / 4; ++q) {
              const float4 c4 = *reinterpret_cast<const float4*>(&colr[t * MR + 4 * q]);
              const float cs[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
              for (int l = 0; l < 4; ++l) {
                if constexpr (PRED) {
                  relax<SR, true>(v[4 * q + l], p[4 * q + l], cs[l], P[t], PP[t]);
                } else {
                  int unused = 0;
                  relax<SR, false>(v[4 * q + l], unused, cs[l], P[t], PP[t]);
                }
              }
            }
          }
        }
        ++m;
      }
    }
  }
  // No CTA leaves while another may still read its slots.
  cluster_arrive();
  cluster_wait();

  if (mine) {
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      if (r < nr) {
        out[(long long)(r0 + r) * b + j] = Storage<T>::round(v[r]);
        if constexpr (PRED) pout[(long long)(r0 + r) * b + j] = p[r];
      }
    }
  }
  // Read afresh here, where nothing else is live, so that the record costs
  // the closure no register.
  if (blockIdx.x == 0 && j == 0) g_closure_cluster[PRED ? 1 : 0] = cluster_size();
}

// Launch `kernel` as `tiles` clusters of `cluster` CTAs.
template <class... Params, class... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), int tiles, int cluster, int threads,
                            int shared, cudaStream_t s, Args... args) {
  if (shared > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           shared);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = shared;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The large-tile closure, for kCloseMaxB < B: the same B sequential steps
// A <- A ⊕ A[:, k] ⊗ A[k, :], each reading the old row and column k, as the
// JAX step does (src/repro/kernels/fw_block.py:79-91), so its bits are the
// plain version's under negative cycles and NaN too.
//
// Layout.  One cooperative launch (co-resident CTAs, at most one an SM) of
// kGridThreads threads a CTA closes `tiles` tiles of B x B in place in
// their f32 outputs: CTA c owns rows c, c + C, ... of the stacked tiles
// (tile t's row r is row t*B + r), thread j of it columns j, j + kGridThreads,
// ..., the same elements at every step, so an element is only ever read and
// written by its own thread.  The old row and column of pivot k live in a
// double-buffered scratch ("lines"): the thread that finishes element
// (k+1, c) at step k writes it to row line k+1, the one that finishes
// (r, k+1) to column line k+1, and one grid barrier later step k+1 reads
// them.  A line is rewritten two steps after it was read, with a barrier
// between, so one barrier a step suffices.
//
// What bounds it.  A chain of B steps, each one grid barrier (an atomic
// arrival and a spin on one counter in L2) and one pass over the tile
// through L2: the card-wide operations bound is out of reach, as for the
// cluster closure.  PERF.md has its time a step at B = 512 and 1024.
constexpr int kGridThreads = 512;

// The scratch of grid_close in 4-byte words: the barrier counter (4 words,
// reset by the launch), row lines [tiles][2][b], column lines [tiles][2][b]
// and, with preds, pred row lines [tiles][2][b].
__host__ __device__ constexpr long long grid_lines_words(int b, int tiles, bool pred) {
  return 4 + 2LL * tiles * b * (pred ? 3 : 2);
}

// The launch plan (kernels/fw_block.py closure_launch) that the grid
// closure runs: no cluster (0), no rows in registers (0), kGridThreads
// threads, no dynamic shared memory.
__host__ __device__ inline bool grid_plan_ok(int b, int cluster, int rows, int threads,
                                             int shared) {
  return b > kCloseMaxB && cluster == 0 && rows == 0 && threads == kGridThreads && shared == 0;
}

__device__ __forceinline__ unsigned ld_acquire_gpu(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Every CTA of the grid meets here (a cooperative launch makes them
// co-resident).  The counter starts at 0 and counts arrivals, so barrier
// number `phase` (1, 2, ...) waits for phase * gridDim.x of them.  The CTA
// barrier orders its threads' writes before thread 0's fence and arrival;
// the acquire load and the second CTA barrier order the other CTAs' writes
// before its threads' reads.
__device__ __forceinline__ void grid_barrier(unsigned* count, unsigned phase) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1u);
    const unsigned target = phase * gridDim.x;
    while (ld_acquire_gpu(count) < target) {
    }
  }
  __syncthreads();
}

// Close `tiles` tiles, tile t b x b at d + t * tstride (row stride ld,
// storage T), with int32 preds at pg + t*b*b (row stride b) when PRED.
// Writes the closed tiles to out (tiles x b x b, contiguous), rounded
// through the storage type, and the preds to pout.  lines holds
// grid_lines_words(b, tiles, PRED) words, the counter at 0 at launch.
// Every thread of the grid must call it.
template <int SR, bool PRED, class T>
__device__ __forceinline__ void grid_close(const T* __restrict__ d, long long ld,
                                           long long tstride, const int* __restrict__ pg,
                                           float* __restrict__ out, int* __restrict__ pout,
                                           int b, int tiles, int* lines) {
  unsigned* bar = reinterpret_cast<unsigned*>(lines);
  float* rowl = reinterpret_cast<float*>(lines + 4);               // [tiles][2][b]
  float* coll = rowl + 2LL * tiles * b;                            // [tiles][2][b]
  int* prowl = reinterpret_cast<int*>(coll + 2LL * tiles * b);     // [tiles][2][b], PRED
  const long long nrows = (long long)tiles * b, bb = (long long)b * b;
  unsigned phase = 0;
  for (long long R = blockIdx.x; R < nrows; R += gridDim.x) {
    const long long t = R / b;
    const int r = static_cast<int>(R - t * b);
    for (int c = threadIdx.x; c < b; c += blockDim.x) {
      const long long e = t * bb + (long long)r * b + c;
      const float v = Storage<T>::load(d[t * tstride + r * ld + c]);
      out[e] = v;
      if (r == 0) rowl[2 * t * b + c] = v;
      if (c == 0) coll[2 * t * b + r] = v;
      if constexpr (PRED) {
        const int pv = pg[e];
        pout[e] = pv;
        if (r == 0) prowl[2 * t * b + c] = pv;
      }
    }
  }
  grid_barrier(bar, ++phase);
  for (int k = 0; k < b; ++k) {
    const int cur = k & 1, nxt = cur ^ 1;
    for (long long R = blockIdx.x; R < nrows; R += gridDim.x) {
      const long long t = R / b;
      const int r = static_cast<int>(R - t * b);
      const long long line = (2 * t + cur) * b, next = (2 * t + nxt) * b;
      const float a = __ldcg(&coll[line + r]);
      float* orow = out + t * bb + (long long)r * b;
      int* prow = PRED ? pout + t * bb + (long long)r * b : nullptr;
      for (int c = threadIdx.x; c < b; c += blockDim.x) {
        const float old = orow[c];
        float x = old;
        int px = 0;
        if constexpr (PRED) {
          px = prow[c];
          const int op = px;
          relax<SR, true>(x, px, a, __ldcg(&rowl[line + c]), __ldcg(&prowl[line + c]));
          if (px != op) prow[c] = px;
        } else {
          relax<SR, false>(x, px, a, __ldcg(&rowl[line + c]), 0);
        }
        if (__float_as_uint(x) != __float_as_uint(old)) orow[c] = x;
        if (r == k + 1) {
          rowl[next + c] = x;
          if constexpr (PRED) prowl[next + c] = px;
        }
        if (c == k + 1) coll[next + r] = x;
      }
    }
    if (k + 1 < b) grid_barrier(bar, ++phase);
  }
  if constexpr (!std::is_same<T, float>::value) {
    // Each element is its own thread's: no barrier before the rounding.
    for (long long R = blockIdx.x; R < nrows; R += gridDim.x)
      for (int c = threadIdx.x; c < b; c += blockDim.x) {
        float* o = out + R * b + c;
        *o = Storage<T>::round(*o);
      }
  }
}

// Launch `kernel` (which runs grid_close over `rows` = tiles * b rows) as
// one cooperative grid of min(SMs, rows) CTAs of kGridThreads, after
// setting the barrier counter at the head of `lines` to 0.
template <class... Params, class... Args>
cudaError_t launch_grid_close(void (*kernel)(Params...), long long rows, int* lines,
                              cudaStream_t s, Args... args) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kGridThreads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1 || sms < 1) return cudaErrorInvalidConfiguration;
  if ((err = cudaMemsetAsync(lines, 0, sizeof(unsigned), s)) != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows < sms ? rows : sms));
  cfg.blockDim = dim3(kGridThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace repro_torch
