// Exact-fp32 delay-line multiply-accumulate for Hopper (sm_90a).
//
//   out[o, k, b] (+)= sum_r fdl[k, r, b] * h[k, o, r]
//
// fdl [K, R, B], h [K, O, R], out [O, K, B], all float32, batch minor.
//
// Replaces the Pallas TPU kernel airwave_tpu/kernels/mac_kmajor.py:mac_kmajor
// (body _mac_body). It is the UPOLS delay-line contraction: per frequency bin
// k, R = speakers x partitions x (re, im) rows of the delay line against the
// bin's O = ears x (re, im) filter columns (single-block step), or one page
// of the paged delay line, R = speakers x (re, im) x M slots against
// O = M x ears x (re, im) columns (paged step).
//
// What bounds it on this card: device-memory bandwidth. Each (k, b) reads R
// floats of the delay line and writes O floats (and reads them back when
// accumulating) for 2*O*R flops: at O = R = 32 that is about 5 flop/byte,
// far below the H100's fp32 ridge, and the delay line (GBs at B = 16384) is
// streamed from HBM every step. The design therefore reads every delay-line
// element exactly once, fully coalesced:
//   - one CTA per (bin k, tile of 256 batch lanes); the batch sits on
//     threadIdx.x, so each row r of fdl is one contiguous 1 KB span per CTA;
//   - the bin's h[k] (O*R*4 bytes: 640 B single-block, 4 KB paged) is staged
//     in shared memory once per CTA, transposed to [R, O] so that one
//     float4 load brings four output columns; all threads of a warp read the
//     same address, a broadcast. With one scalar load per FMA the O = 32
//     case was bound by shared-memory load issue, not by HBM;
//   - r outer, o inner: each fdl element is loaded once into a register and
//     FMA'd into O register accumulators (fmaf, IEEE fp32, no fast-math);
//   - the O outputs are stored coalesced along b; `accumulate` adds into
//     the existing out, which is how the paged step sums its pages into one
//     accumulator without a separate add pass. All O old values are loaded
//     before the first store: interleaved load/add/store through one
//     pointer at runtime offsets may alias, so the compiler would keep them
//     in order, one memory latency per column.
// The Pallas kernel's VMEM tiling, sublane padding and sequential grid have
// no counterpart here: CTAs run in any order and share nothing.
//
// ---------------------------------------------------------------------------
// mac_kmajor_pages: every page of the paged delay line in one launch.
//
//   out[o, k, b] = sum_a sum_r page_a[k, r, b] * bank[a, k, o, r]
//
// pages: n tensors [K, R, B] (separate buffers: the paged step rotates them
// by renaming), bank [n, K, O, R], out [O, K, B], all float32, batch minor.
//
// Replaces the paged use of the Pallas kernel above, i.e. the function
// airwave_tpu/ops/upols.py:_paged_mac (one contraction per page, summed into
// one accumulator), which the port first ran as one mac_kmajor launch per
// page with `accumulate`.
//
// What bounds it on this card: bytes. At the paged step's shape (n = 3,
// K = 520, R = 32, O = 32, B = 16384) the function reads 3.27 GB of pages and
// writes 1.09 GB, 1.30 ms at 3.35 TB/s; its 52 GFLOP of fp32 FMAs take
// 0.78 ms at the CUDA cores' 67 TFLOP/s, so the FMAs must overlap the
// stream almost fully. The per-page launches moved 8.7 GB (two round trips
// of the accumulator) and kept one register load per thread and row in
// flight. The design:
//   - each (bin k, tile of 256 lanes) is summed over every page and row by
//     one CTA: the sums stay in registers and out is written once, with no
//     atomics. The CTAs are persistent (as many as fit on the card) and
//     walk the tiles, so the ring below keeps loading across tiles and no
//     CTA start or drain leaves the card idle;
//   - a producer warp stages the rows into a ring of kPagesStages stages of
//     kPagesRows rows with TMA bulk copies (cp.async.bulk, one 1 KB copy
//     per row of the tile, completing on the stage's mbarrier with
//     expect-tx): up to 64 KB in flight per CTA, and no consumer thread
//     spends a register or an instruction on addresses. Consumer warps
//     wait on a stage's "full" barrier and release it on its "empty"
//     barrier, with no __syncthreads in the loop;
//   - at a page's first stage the producer also copies the page's bank (by
//     cp.async, completing through cp.async.mbarrier.arrive) into the
//     second of two buffers, which the consumers release at the page's end.
//     It is transposed to [R][O], so one float4 holds 4 columns of a row,
//     read as a broadcast; shared memory grows with R but not with n;
//   - each consumer thread holds 4 adjacent lanes x 8 columns (4 warp-
//     uniform column groups): per row one float4 of lanes and two float4 of
//     columns feed 32 FMAs, and a thread keeps 64 sums and partials. All 32
//     columns in one thread needed 128 of them and ptxas spilled;
//   - exact fp32 on the CUDA cores, no tensor cores: each page's partial sum
//     starts at zero and runs fmaf in r order, and the partials are added to
//     the sum in page order, (p0 + p1) + p2 as the accumulate launches
//     computed it, so the two agree bit for bit. Rows are padded with zeros
//     to whole stages (fmaf(0, 0, p) == p; only a -0 partial turns +0);
//   - ragged shapes in the same kernel: rows take bulk copies when
//     B % 4 == 0 and the pages are 16-byte aligned, else 4-byte cp.async by
//     the producer's 32 lanes; lanes past B are never stored. An O that is
//     a multiple of 32 takes 32 columns per pass over the pages (one pass at
//     the steady O = 32, two at a hot-swap round's dual-bank O = 64); any
//     other O takes 16 columns per pass (re-reading the pages), padded with
//     zero columns.
//
// The single-block kernel has fixed instances for the steady O = 4, the
// dual-bank O = 8 of a hot-swap round and the paged O = 32; any other O runs
// the generic kernel, which takes the columns 4 at a time and re-reads the
// CTA's rows once per 4 columns. Every instance keeps each column's fmaf
// chain in r order, so all routes agree bit for bit.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 4;  // output columns per pass of the generic path

template <int O>
__global__ void __launch_bounds__(kThreads)
mac_kmajor_fixed(const float* __restrict__ fdl, const float* __restrict__ h,
                 float* __restrict__ out, int K, int R, int B, int accumulate) {
  static_assert(O % 4 == 0, "float4 reads of h need O % 4 == 0");
  extern __shared__ float4 hs4[];  // h[k] transposed: [R, O]
  float* hs = reinterpret_cast<float*>(hs4);
  const int k = blockIdx.y;
  const float* hk = h + static_cast<size_t>(k) * O * R;
  for (int i = threadIdx.x; i < O * R; i += kThreads) {
    const int o = i / R;
    hs[(i - o * R) * O + o] = hk[i];
  }
  __syncthreads();

  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;

  float acc[O];
#pragma unroll
  for (int o = 0; o < O; ++o) acc[o] = 0.0f;

  const float* x = fdl + static_cast<size_t>(k) * R * B + b;
#pragma unroll 4
  for (int r = 0; r < R; ++r) {
    const float xv = __ldg(x + static_cast<size_t>(r) * B);
    const float4* hr = hs4 + r * (O / 4);
#pragma unroll
    for (int q = 0; q < O / 4; ++q) {
      const float4 w = hr[q];
      acc[4 * q + 0] = fmaf(xv, w.x, acc[4 * q + 0]);
      acc[4 * q + 1] = fmaf(xv, w.y, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(xv, w.z, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(xv, w.w, acc[4 * q + 3]);
    }
  }

  float* y = out + static_cast<size_t>(k) * B + b;
  const size_t plane = static_cast<size_t>(K) * B;
  if (accumulate) {
#pragma unroll
    for (int o = 0; o < O; ++o) acc[o] = y[o * plane] + acc[o];
  }
#pragma unroll
  for (int o = 0; o < O; ++o) y[o * plane] = acc[o];
}

// Any O: the columns are taken kChunk at a time, re-reading the CTA's fdl
// rows (from L1/L2) once per chunk.
__global__ void __launch_bounds__(kThreads)
mac_kmajor_generic(const float* __restrict__ fdl, const float* __restrict__ h,
                   float* __restrict__ out, int K, int R, int B, int O,
                   int accumulate) {
  extern __shared__ float hs[];  // h[k] as [O, R]
  const int k = blockIdx.y;
  const float* hk = h + static_cast<size_t>(k) * O * R;
  for (int i = threadIdx.x; i < O * R; i += kThreads) hs[i] = hk[i];
  __syncthreads();

  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;

  const float* x = fdl + static_cast<size_t>(k) * R * B + b;
  float* y = out + static_cast<size_t>(k) * B + b;
  const size_t plane = static_cast<size_t>(K) * B;
  for (int o0 = 0; o0 < O; o0 += kChunk) {
    const int n = min(kChunk, O - o0);
    float acc[kChunk] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int r = 0; r < R; ++r) {
      const float xv = __ldg(x + static_cast<size_t>(r) * B);
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (j < n) acc[j] = fmaf(xv, hs[(o0 + j) * R + r], acc[j]);
      }
    }
    if (accumulate) {
      for (int j = 0; j < n; ++j) acc[j] = y[(o0 + j) * plane] + acc[j];
    }
    for (int j = 0; j < n; ++j) y[(o0 + j) * plane] = acc[j];
  }
}

// --- mac_kmajor_pages --------------------------------------------------------

constexpr int kLaneThreads = 64;    // consumer threads along a tile's lanes
constexpr int kColGroups = 4;       // consumer thread groups along the columns
constexpr int kConsumerWarps = kLaneThreads * kColGroups / 32;
constexpr int kPagesThreads = (kConsumerWarps + 1) * 32;  // + producer warp
constexpr int kPagesTile = 4 * kLaneThreads;  // lanes per CTA, 4 per thread
constexpr int kPagesRows = 16;                // rows per ring stage
constexpr int kPagesStages = 4;               // ring depth
constexpr int kMaxPages = 32;
constexpr int kRingFloats = kPagesStages * kPagesRows * kPagesTile;
constexpr int kBarrierBytes = 128;            // the mbarriers, ahead of the ring
static_assert(kLaneThreads % 32 == 0, "column groups are whole warps");
static_assert((2 * kPagesStages + 4) * 8 <= kBarrierBytes, "barrier space");

struct PagePtrs {
  const float* p[kMaxPages];
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Per-thread asynchronous copy of one float into shared memory; with
// src_bytes 0 it writes a zero and reads nothing.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

// Arrive on the mbarrier once this thread's earlier cp.async copies have
// landed; it is one of the barrier's expected arrivals.
__device__ __forceinline__ void cp_async_arrive(unsigned bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(bar) : "memory");
}

// TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned),
// counted against the mbarrier's expected transaction bytes.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned bar,
                                                      unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Spin until the phase with this parity has completed.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n"
      :: "r"(bar), "r"(parity) : "memory");
}

// Shared memory of one CTA: the mbarriers, the row ring and two bank
// buffers of [Rp][OCP] floats, Rp = R rounded up to whole stages.
__host__ __device__ inline size_t pages_smem_bytes(int R, int OCP) {
  const int rp = (R + kPagesRows - 1) / kPagesRows * kPagesRows;
  return kBarrierBytes + sizeof(float) * (static_cast<size_t>(kRingFloats) +
                                          2 * static_cast<size_t>(rp) * OCP);
}

// The producer's copies of one page's bank: bank[a, k] columns o0 .. o0 +
// OCP - 1 transposed to [r][o - o0] (a float4 holds 4 columns of one row),
// rp rows, the pads zero; the caller then arrives on the bank's barrier.
template <int OCP>
__device__ __forceinline__ void load_bank(float* dst, const float* hk, int o0,
                                          int O, int R, int rp, int lane) {
  for (int i = lane; i < rp * OCP; i += 32) {
    const int r = i / OCP;
    const int o = o0 + i - r * OCP;
    const bool ok = o < O && r < R;
    cp_async4(dst + i, ok ? hk + static_cast<size_t>(o) * R + r : hk,
              ok ? 4 : 0);
  }
}

// The producer's copies of one stage: `rows` rows of `span` lanes from src
// (row stride B) into a ring slot of kPagesRows rows; the slot's rows past
// `rows` become zeros. Completes on the stage's barrier `bar`.
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int rows, int span, int B,
                                          int rows_bulk, int lane,
                                          unsigned bar) {
  if (rows_bulk) {
    // The zeros are written before the slot's later bulk copies (the async
    // proxy) overwrite them.
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int i = rows * (kPagesTile / 4) + lane;
         i < kPagesRows * (kPagesTile / 4); i += 32) {
      d4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (lane == 0) {
      mbar_arrive_expect_tx(bar, rows * span * 4);
      for (int d = 0; d < rows; ++d) {
        bulk_copy(dst + d * kPagesTile, src + static_cast<size_t>(d) * B,
                  span * 4, bar);
      }
    } else {
      mbar_arrive(bar);
    }
  } else {
    for (int i = lane; i < kPagesRows * span; i += 32) {
      const int d = i / span;
      const int l = i - d * span;
      const bool ok = d < rows;
      cp_async4(dst + d * kPagesTile + l,
                ok ? src + static_cast<size_t>(d) * B + l : src, ok ? 4 : 0);
    }
    cp_async_arrive(bar);
  }
}

// A consumer's FMAs on one stage: for each row, one float4 of its 4 lanes
// (xs) against OCT/4 float4 of its columns (hq, row stride OCP floats), in
// row order into part[lane][column].
template <int OCT, int OCP>
__device__ __forceinline__ void mac_stage(float (&part)[4][OCT],
                                          const float4* xs, const float4* hq) {
#pragma unroll
  for (int d = 0; d < kPagesRows; ++d) {
    const float4 x4 = xs[d * (kPagesTile / 4)];
    const float x[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
    for (int q = 0; q < OCT / 4; ++q) {
      const float4 w4 = hq[d * (OCP / 4) + q];
      const float w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          part[j][4 * q + c] = fmaf(x[j], w[c], part[j][4 * q + c]);
        }
      }
    }
  }
}

// Persistent CTAs walk the work items (bin k, tile of kPagesTile lanes).
// The last warp produces: for each stage (page a, rows blk * kPagesRows on)
// it waits for the slot to be released and fills it, and at a page's first
// stage it first copies the page's bank into the bank buffer the consumers
// released. The consumer warps wait for a stage, multiply it and release
// it. Each consumer thread holds 4 adjacent lanes x OCT columns: per row one
// float4 of lanes and OCT/4 float4 of columns feed 4 * OCT FMAs. A pass over
// the pages covers OCP = kColGroups * OCT columns (all of O = 32 or 16);
// group cg (warp-uniform, so bank reads stay broadcasts) takes columns
// cg * OCT onwards of the pass. Both roles count stages (it) and page banks
// (pg) over all work items and passes: the k-th use of a ring slot or bank
// buffer is the barriers' phase k.
template <int OCT>
__global__ void __launch_bounds__(kPagesThreads, 2)
mac_kmajor_pages_kernel(const __grid_constant__ PagePtrs pages,
                        const float* __restrict__ bank,
                        float* __restrict__ out, int n, int K, int R, int B,
                        int O, int rows_bulk, int out_vec) {
  static_assert(OCT % 4 == 0, "whole float4 runs of columns per group");
  constexpr int OCP = kColGroups * OCT;
  constexpr int kSlotFloats = kPagesRows * kPagesTile;
  extern __shared__ __align__(16) unsigned char smem[];
  const unsigned bars = smem_addr(smem);
  const unsigned full = bars;                          // [stages]
  const unsigned empty = bars + 8 * kPagesStages;      // [stages]
  const unsigned bank_full = bars + 16 * kPagesStages; // [2]
  const unsigned bank_empty = bank_full + 16;          // [2]
  float* ring = reinterpret_cast<float*>(smem + kBarrierBytes);  // [st][row][lane]
  float* hs = ring + kRingFloats;                                // [2][Rp][OCP]
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int tiles = (B + kPagesTile - 1) / kPagesTile;  // tiles per bin
  const int nblk = (R + kPagesRows - 1) / kPagesRows;
  const int rp = nblk * kPagesRows;  // rows per page, padded
  const int total = n * nblk;        // stages per pass

  if (tid == 0) {
    for (int i = 0; i < kPagesStages; ++i) {
      mbar_init(full + 8 * i, 32);  // one arrival per producer lane
      mbar_init(empty + 8 * i, kConsumerWarps);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(bank_full + 8 * i, 32);
      mbar_init(bank_empty + 8 * i, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int it = 0;
  int pg = 0;
  if (tid / 32 == kConsumerWarps) {  // the producer
    for (int wi = blockIdx.x; wi < K * tiles; wi += gridDim.x) {
      const int k = wi / tiles;
      const int b0 = (wi - k * tiles) * kPagesTile;
      for (int o0 = 0; o0 < O; o0 += OCP) {
        for (int s = 0; s < total; ++s, ++it) {
          const int a = s / nblk;
          const int blk = s - a * nblk;
          if (blk == 0) {
            const int buf = pg & 1;
            if (pg >= 2) mbar_wait(bank_empty + 8 * buf, ((pg >> 1) - 1) & 1);
            load_bank<OCP>(hs + buf * rp * OCP,
                           bank + (static_cast<size_t>(a) * K + k) * O * R,
                           o0, O, R, rp, lane);
            cp_async_arrive(bank_full + 8 * buf);
            ++pg;
          }
          const int slot = it % kPagesStages;
          if (it >= kPagesStages) {
            mbar_wait(empty + 8 * slot, ((it / kPagesStages) - 1) & 1);
          }
          const int r0 = blk * kPagesRows;
          load_rows(ring + slot * kSlotFloats,
                    pages.p[a] + (static_cast<size_t>(k) * R + r0) * B + b0,
                    min(kPagesRows, R - r0), min(kPagesTile, B - b0), B,
                    rows_bulk, lane, full + 8 * slot);
        }
      }
    }
    return;
  }

  const int lt = tid % kLaneThreads;  // lanes b0 + 4 * lt .. + 3
  const int cg = tid / kLaneThreads;  // column group
  for (int wi = blockIdx.x; wi < K * tiles; wi += gridDim.x) {
    const int k = wi / tiles;
    const int b = (wi - k * tiles) * kPagesTile + 4 * lt;
    for (int o0 = 0; o0 < O; o0 += OCP) {
      float sum[4][OCT], part[4][OCT];
#pragma unroll
      for (int o = 0; o < OCT; ++o) {
#pragma unroll
        for (int j = 0; j < 4; ++j) sum[j][o] = part[j][o] = 0.0f;
      }
      for (int s = 0; s < total; ++s, ++it) {
        const int a = s / nblk;
        const int blk = s - a * nblk;
        const int slot = it % kPagesStages;
        if (blk == 0) mbar_wait(bank_full + 8 * (pg & 1), (pg >> 1) & 1);
        mbar_wait(full + 8 * slot, (it / kPagesStages) & 1);
        mac_stage<OCT, OCP>(
            part, reinterpret_cast<const float4*>(ring + slot * kSlotFloats) + lt,
            reinterpret_cast<const float4*>(
                hs + ((pg & 1) * rp + blk * kPagesRows) * OCP + cg * OCT));
        __syncwarp();  // the warp's reads of the stage (and bank) are done
        if (lane == 0) mbar_arrive(empty + 8 * slot);
        if (blk == nblk - 1) {
#pragma unroll
          for (int o = 0; o < OCT; ++o) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              sum[j][o] = a == 0 ? part[j][o] : sum[j][o] + part[j][o];
              part[j][o] = 0.0f;
            }
          }
          if (lane == 0) mbar_arrive(bank_empty + 8 * (pg & 1));
          ++pg;
        }
      }

#pragma unroll
      for (int o = 0; o < OCT; ++o) {
        const int col = o0 + cg * OCT + o;
        if (col < O && b < B) {
          float* y = out + (static_cast<size_t>(col) * K + k) * B + b;
          if (out_vec) {
            *reinterpret_cast<float4*>(y) =
                make_float4(sum[0][o], sum[1][o], sum[2][o], sum[3][o]);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (b + j < B) y[j] = sum[j][o];
            }
          }
        }
      }
    }
  }
}

template <int OCT>
cudaError_t launch_pages(const PagePtrs& pages, const float* bank, float* out,
                         int n, int K, int R, int B, int O, int rows_bulk,
                         int out_vec, cudaStream_t s) {
  const size_t smem = pages_smem_bytes(R, kColGroups * OCT);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mac_kmajor_pages_kernel<OCT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  // Persistent CTAs, as many as fit on the card at once, walk the
  // (bin, tile) work items, so a CTA's ring keeps loading across items.
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, mac_kmajor_pages_kernel<OCT>, kPagesThreads, smem);
  }
  if (err != cudaSuccess) return err;
  const long long work =
      static_cast<long long>(K) * ((B + kPagesTile - 1) / kPagesTile);
  if (work > INT32_MAX) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(
      std::min<long long>(work, static_cast<long long>(std::max(per_sm, 1)) * sms));
  mac_kmajor_pages_kernel<OCT><<<grid, kPagesThreads, smem, s>>>(
      pages, bank, out, n, K, R, B, O, rows_bulk, out_vec);
  return cudaGetLastError();
}

// Columns per pass over the pages: 32 for a multiple of 32, else 16.
// `columns` 16 or 32 forces one of the two instances (the A/B of a dispatch
// change); 0 picks by O.
int pages_columns(int O, int columns) {
  if (columns != 0) return columns;
  return O % 32 == 0 ? 32 : kColGroups * 4;
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) and returns
// cudaGetLastError() as an int: 0 means the launch was accepted. The caller
// validates shapes, dtypes, contiguity and the shared-memory size. `generic`
// nonzero runs the generic kernel whatever O is (the A/B of a dispatch
// change).
extern "C" int airwave_mac_kmajor(const float* fdl, const float* h, float* out,
                                  int K, int R, int B, int O, int accumulate,
                                  int generic, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((B + kThreads - 1) / kThreads, K);
  const size_t smem = static_cast<size_t>(O) * R * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (generic ? 0 : O) {
    case 4:
      mac_kmajor_fixed<4><<<grid, kThreads, smem, s>>>(fdl, h, out, K, R, B,
                                                       accumulate);
      break;
    case 8:
      mac_kmajor_fixed<8><<<grid, kThreads, smem, s>>>(fdl, h, out, K, R, B,
                                                       accumulate);
      break;
    case 32:
      mac_kmajor_fixed<32><<<grid, kThreads, smem, s>>>(fdl, h, out, K, R, B,
                                                        accumulate);
      break;
    default:
      mac_kmajor_generic<<<grid, kThreads, smem, s>>>(fdl, h, out, K, R, B, O,
                                                      accumulate);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of one mac_kmajor_pages CTA for these R and O; the
// caller checks it against the card's opt-in limit.
extern "C" long long airwave_mac_kmajor_pages_smem(int R, int O,
                                                    int columns) {
  return static_cast<long long>(pages_smem_bytes(R, pages_columns(O, columns)));
}

// pages: n (1..32) device pointers to [K, R, B]; launches on `stream` and
// returns cudaGetLastError() as an int, as airwave_mac_kmajor does.
// `columns` is 0 (by O), 16 or 32, as pages_columns takes it.
extern "C" int airwave_mac_kmajor_pages(const float* const* pages, int n,
                                        const float* bank, float* out, int K,
                                        int R, int B, int O, int columns,
                                        int device, void* stream) {
  if (n < 1 || n > kMaxPages) return static_cast<int>(cudaErrorInvalidValue);
  if (columns != 0 && columns != 16 && columns != 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  PagePtrs p{};
  int rows_bulk = B % 4 == 0;  // every row 16-byte aligned, whole 16 B
  for (int a = 0; a < n; ++a) {
    p.p[a] = pages[a];
    rows_bulk = rows_bulk && reinterpret_cast<uintptr_t>(pages[a]) % 16 == 0;
  }
  const int out_vec = B % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pages_columns(O, columns) == 32) {
    err = launch_pages<8>(p, bank, out, n, K, R, B, O, rows_bulk, out_vec, s);
  } else {
    err = launch_pages<4>(p, bank, out, n, K, R, B, O, rows_bulk, out_vec, s);
  }
  return static_cast<int>(err);
}

extern "C" const char* airwave_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
