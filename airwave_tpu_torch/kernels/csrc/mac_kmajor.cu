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
// What bounds it on this card. At the steady O = 32 (n = 3, K = 520, R = 32)
// the function reads 384 B of pages and writes 128 B per (k, b) for 12 flop
// per byte, under the CUDA cores' ridge of 67 TFLOP/s / 3.35 TB/s = 20: bytes
// bound it (1.30 ms at B = 16384). A hot-swap round's dual bank, O = 64,
// moves 640 B per (k, b) if it reads each page once and does 19 flop per
// byte: bytes and FMAs both (1.63 and 1.56 ms). In practice the consumers'
// instruction issue and shared-memory reads bound both well before HBM
// does, so the design reads every page element once at every B, spends no
// consumer instruction on addresses, copies or spills, and writes out once:
//   - persistent CTAs (as many as fit) each walk their own contiguous run of
//     work items (bin k, tile of 256 lanes), so consecutive items mostly
//     share a bin; each item is summed over every page and row by one CTA,
//     out is written once with no atomics, and the ring below keeps loading
//     across items;
//   - a producer warp fills a ring of stages of 16 rows with TMA bulk copies
//     (cp.async.bulk, completing on the stage's mbarrier with expect-tx)
//     whatever B and the page bases are: each row copies its 16-byte-aligned
//     envelope, rounded out to whole 16 B, into a slot row one float4 wider
//     than the tile, and the consumers read the row from its shift m (the
//     row start's float index mod 4, the same for the whole warp; the
//     shifts repeat every 4 rows). The envelope never leaves the page: where
//     it would start before the page (a base that is not 16-byte aligned)
//     or end past it, those few floats are copied by 4-byte cp.async, which
//     arrives on the same barrier. Consumers wait on a stage's "full"
//     barrier and release it on its "empty" barrier, with no __syncthreads
//     in the loop;
//   - the bank, transposed to [row][column] so one float4 holds 4 columns
//     of a row (read as a broadcast): when the n pages' banks fit beside a
//     ring of at least 2 stages, each page's stays resident for the CTA's
//     current bin, loaded once per bin and not once per tile (reloading it
//     per tile by 4-byte copies cost more than the FMAs at O = 32), and the
//     ring takes the stages that are left (the three pages of a 5.1 or 7.1
//     input, R = 96 or 128, keep 2-5); else (a long bank of many pages)
//     each stage carries its own rows of the bank, copied two 64-byte runs
//     an instruction, so shared memory does not grow with R;
//   - each consumer thread keeps 4 lanes x 8 columns of partials (32
//     registers) and its running page sums in shared memory, under the
//     96-register budget of the ~18 warps per SM the FMA loop needs to hide
//     its latency. Where every row is 16-byte aligned (B % 4 == 0, aligned
//     bases) a thread's 4 lanes are adjacent: one float4 load a row and
//     float4 stores. Else they are strided by 32 (lanes l, l + 32, l + 64,
//     l + 96 of the warp's 128): a row's 4 scalar loads are conflict-free
//     at every shift, and each store of a column covers 128 contiguous
//     bytes of out whatever B % 4 is. A warp whose 128 lanes all lie past B
//     (the last tile of a bin at B % 256 <= 128) skips the FMAs;
//   - a pass over the pages takes C columns, C / 8 warp-uniform column
//     groups of 2 warps: C = 32 for the steady O = 32 (two CTAs per SM,
//     up to 4 stages); C = 64 for the dual-bank O = 64, so its pages are
//     read once (16 consumer warps, one CTA per SM, up to 8 stages); C = 48
//     for the three-half O = 96 (two passes, not three of 32); C = 16 (4
//     columns a thread) for any other O (zero columns pad the last pass)
//     and as the A/B baseline;
//   - exact fp32 on the CUDA cores, no tensor cores: wgmma takes fp32 only
//     as TF32, and a split-TF32 product would be another (relaxed) tier.
//     Each page's partial sum starts at zero and runs fmaf in r order, and
//     the partials are added to the sum in page order, (p0 + p1) + p2 as
//     the accumulate launches computed it, so every route agrees with them
//     bit for bit. Rows are padded with zeros to whole stages (fmaf(0, 0, p)
//     == p; only a -0 partial turns +0).
//
// The single-block kernel has fixed instances for the steady O = 4, the
// dual-bank O = 8 of a hot-swap round, the three-half O = 12 of a second
// swap while fades are pending and the paged O = 32; any other O runs
// the generic kernel, which takes the columns 4 at a time and re-reads the
// CTA's rows once per 4 columns. Every instance keeps each column's fmaf
// chain in r order, so all routes agree bit for bit.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <type_traits>

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

constexpr int kLaneWarps = 2;         // consumer warps along a tile's lanes
constexpr int kWarpLanes = 4 * 32;    // lanes of a warp, 4 per thread
constexpr int kPagesTile = kLaneWarps * kWarpLanes;  // lanes per work item
constexpr int kPagesRows = 16;        // rows per ring stage
constexpr int kSlotRow = kPagesTile + 4;  // a row's envelope: one float4 more
constexpr int kMaxPages = 32;
constexpr int kFullArrivals = 33;     // 32 producer lanes + the expect-tx
constexpr size_t kSmPerSm = 233472;   // shared memory of an SM (228 KB)
constexpr size_t kSmemReserved = 1024;  // the system's share per CTA

// One instance of the kernel: C columns per pass over the pages, 8 of them
// per consumer thread (4 for C = 16), so C / OCT warp-uniform column groups
// of kLaneWarps warps each, and one producer warp. A thread keeps its 32
// partials in registers and its running page sums in shared memory, under
// the 96-register budget of about 18 warps per SM, with no spills; a pass
// wider than 32 columns runs one CTA per SM (17 or 13 warps) with a deeper
// ring, so its pages are read once. The ring holds 2 .. kMaxStages stages,
// the most that fit beside the resident banks (launch_pages_any).
template <int C>
struct PagesShape {
  static constexpr int kOct = C == 16 ? 4 : 8;
  static constexpr int kConsumerWarps = kLaneWarps * (C / kOct);
  static constexpr int kThreads = (kConsumerWarps + 1) * 32;
  static constexpr bool kWide = C > 32;
  static constexpr int kMaxStages = kWide ? 8 : 4;
  static constexpr int kCtasPerSm = kWide ? 1 : 2;
  static constexpr size_t kSumBytes =
      16 * static_cast<size_t>(kOct) * kConsumerWarps * 32;
  // Shared memory: the mbarriers (full and empty per stage, bank full and
  // empty per page), the sums ([OCT][thread] float4), then the ring of S
  // stages; the resident banks follow it.
  __host__ __device__ static constexpr size_t head_bytes(int S, int n) {
    return (8 * (2 * S + 2 * n) + 15) / 16 * 16 + kSumBytes;
  }
  // A ring slot: kPagesRows rows of kSlotRow floats, and when the bank is
  // streamed, the stage's kPagesRows bank rows of C columns (padded by 4).
  __host__ __device__ static constexpr int slot_floats(bool streamed) {
    return kPagesRows * (kSlotRow + (streamed ? C + 4 : 0));
  }
};
static_assert(kSlotRow % 4 == 0, "slot rows start 16-byte aligned");

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

// The producer's copies of one stage into a ring slot: rows r0 .. r0 + rows
// - 1 of bin k of `page` (its `page_floats` elements), lanes b0 .. b0 + span
// - 1, lane d of the warp taking row d: the row's 16-byte envelope by one
// bulk copy, clipped to the page, and the floats the clipping left out by
// cp.async (the row starts at float (start mod 16) / 4 of its slot row).
// Rows past `rows` are zeros. Everything completes on the stage's barrier.
__device__ __forceinline__ void load_rows(float* xs, const float* page,
                                          size_t page_floats, int k, int r0,
                                          int rows, int b0, int span, int R,
                                          int B, int lane, unsigned bar) {
  if (rows < kPagesRows) {
    float4* d4 = reinterpret_cast<float4*>(xs);
    for (int i = rows * (kSlotRow / 4) + lane; i < kPagesRows * (kSlotRow / 4);
         i += 32) {
      d4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
  // The slot's earlier writes through the generic proxy (these zeros, the
  // cp.async floats of its last use) are ordered before the bulk copies.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  // Byte addresses: the row [s, e), its envelope from e0, the bulk part
  // [lo, hi) of it that lies inside the page.
  uintptr_t s = 0, e = 0, e0 = 0, lo = 0, hi = 0;
  if (lane < rows) {
    const uintptr_t base = reinterpret_cast<uintptr_t>(page);
    const uintptr_t first = (base + 15) & ~uintptr_t{15};
    const uintptr_t last = (base + sizeof(float) * page_floats) & ~uintptr_t{15};
    s = reinterpret_cast<uintptr_t>(
        page + (static_cast<size_t>(k) * R + r0 + lane) * B + b0);
    e = s + sizeof(float) * span;
    e0 = s & ~uintptr_t{15};
    const uintptr_t e1 = (e + 15) & ~uintptr_t{15};
    lo = e0 > first ? e0 : first;
    hi = e1 < last ? e1 : last;
    if (lo >= hi) lo = hi = e;  // no whole 16 B inside: cp.async only
  }
  const unsigned bytes = static_cast<unsigned>(hi - lo);
  const unsigned stage_bytes = __reduce_add_sync(0xffffffffu, bytes);
  if (lane == 0) mbar_arrive_expect_tx(bar, stage_bytes);
  __syncwarp();
  if (lane < rows) {
    float* dst = xs + lane * kSlotRow;
    if (bytes) {
      bulk_copy(dst + (lo - e0) / 4, reinterpret_cast<const void*>(lo), bytes,
                bar);
    }
    for (uintptr_t a = s; a < lo && a < e; a += 4) {
      cp_async4(dst + (a - e0) / 4, reinterpret_cast<const void*>(a), 4);
    }
    for (uintptr_t a = hi > s ? hi : s; a < e; a += 4) {
      cp_async4(dst + (a - e0) / 4, reinterpret_cast<const void*>(a), 4);
    }
  }
  cp_async_arrive(bar);
}

// The producer's copies of all of bank[a, k] (hk, [O, R]) into dst,
// transposed to [pass][row][column] (C columns a pass, rp rows a pass), so
// one float4 holds 4 columns of a row. Rows past R and columns past O (up
// to cw) are zeros. Completes through the caller's cp.async arrival.
template <int C>
__device__ __forceinline__ void load_bank(float* dst, const float* hk, int rp,
                                          int cw, int O, int R, int lane) {
  for (int i = lane; i < rp * cw; i += 32) {
    const int r = i / cw;
    const int o = i - r * cw;
    const bool ok = o < O && r < R;
    cp_async4(dst + (o / C * rp + r) * C + o % C,
              ok ? hk + static_cast<size_t>(o) * R + r : hk, ok ? 4 : 0);
  }
}

// The same for one stage of a streamed bank: rows r0 .. r0 + rows - 1 and
// columns c0 .. c0 + C - 1 into dst [row][C + 4]. Lane l takes row l % 16
// of every other column from l / 16 on, so each instruction reads two
// 64-byte runs of the bank (by lanes along its columns it touched 32 lines),
// and the padded rows keep its shared-memory writes at most 2-way in
// conflict. Rows past `rows` and columns past O are zeros.
template <int C>
__device__ __forceinline__ void load_bank_stage(float* dst, const float* hk,
                                                int r0, int rows, int c0,
                                                int O, int R, int lane) {
  static_assert(32 % kPagesRows == 0, "whole columns per instruction");
  const int r = lane % kPagesRows;
  for (int o = lane / kPagesRows; o < C; o += 32 / kPagesRows) {
    const bool ok = c0 + o < O && r < rows;
    cp_async4(dst + r * (C + 4) + o,
              ok ? hk + static_cast<size_t>(c0 + o) * R + r0 + r : hk,
              ok ? 4 : 0);
  }
}

// A consumer's FMAs on one stage: for each row d, its 4 lanes against OCT/4
// float4 of its columns (hq, row stride HROW floats), in row order into
// part[lane][column]. Row d of this thread's lanes starts at x[d % 4] + d *
// kSlotRow (the rows' shifts repeat every 4 rows). kAligned: the thread's
// lanes are adjacent, one float4; else strided by 32.
template <int OCT, int HROW, bool kAligned>
__device__ __forceinline__ void mac_stage(float (&part)[4][OCT],
                                          const float* x0, const float* x1,
                                          const float* x2, const float* x3,
                                          const float4* hq) {
#pragma unroll
  for (int d = 0; d < kPagesRows; ++d) {
    const float* row =
        (d % 4 == 0 ? x0 : d % 4 == 1 ? x1 : d % 4 == 2 ? x2 : x3) +
        d * kSlotRow;
    float x[4];
    if (kAligned) {
      const float4 x4 = *reinterpret_cast<const float4*>(row);
      x[0] = x4.x;
      x[1] = x4.y;
      x[2] = x4.z;
      x[3] = x4.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) x[j] = row[32 * j];
    }
#pragma unroll
    for (int q = 0; q < OCT / 4; ++q) {
      const float4 w4 = hq[d * (HROW / 4) + q];
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

// Persistent CTAs; CTA g takes the work items [g * W / G, (g + 1) * W / G)
// of the W = K * tiles items (bin k, tile of kPagesTile lanes), in order, so
// its consecutive items mostly share a bin. The last warp produces: for
// each stage (page a, rows r0 on, the pass's columns) it waits for the ring
// slot to be released and fills it. The consumer warps wait for a stage,
// multiply it and release it. The ring has S slots; both roles walk them in
// turn (slot, and the parity of the slot's current use).
//
// The bank: kResident (the n pages' banks, all O columns, fit beside the
// ring): page a's bank has a buffer of its own, loaded at the first item
// of each bin (the f-th fresh bin is its barriers' phase f) and released
// after the bin's last item; else it is streamed: each stage also carries
// its rows of the bank, the pass's C columns.
//
// Consumer warp w takes lanes (w % kLaneWarps) * kWarpLanes on of the tile
// and columns (w / kLaneWarps) * OCT on of the pass (warp-uniform, so bank
// reads stay broadcasts). kAligned (B % 4 == 0, every page and out 16-byte
// aligned: every row has shift 0): a thread's 4 lanes are adjacent, read
// and stored as one float4; else they are strided by 32.
//
// MAC_PAGES_SPLIT, for timing only (chip_smoke.py --split; the sums are
// wrong): 1, the consumers wait for and release every stage but do no
// FMAs; 2, the producer copies no rows. Unset, the kernel is whole.
#ifdef MAC_PAGES_SPLIT
constexpr int kPagesSplit = MAC_PAGES_SPLIT;
#else
constexpr int kPagesSplit = 0;
#endif

template <int C, bool kAligned, bool kResident>
__global__ void __launch_bounds__(PagesShape<C>::kThreads,
                                  PagesShape<C>::kCtasPerSm)
mac_kmajor_pages_kernel(const __grid_constant__ PagePtrs pages,
                        const float* __restrict__ bank,
                        float* __restrict__ out, int n, int K, int R, int B,
                        int O, int S) {
  using Shape = PagesShape<C>;
  constexpr int OCT = Shape::kOct;
  constexpr int kThreadsC = Shape::kConsumerWarps * 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const unsigned full = smem_addr(smem);           // [S]
  const unsigned empty = full + 8 * S;             // [S]
  const unsigned bank_full = empty + 8 * S;        // [n]
  const unsigned bank_empty = bank_full + 8 * n;   // [n]
  float4* sums = reinterpret_cast<float4*>(
      smem + Shape::head_bytes(S, n) - Shape::kSumBytes);
  float* ring = reinterpret_cast<float*>(smem + Shape::head_bytes(S, n));
  constexpr int slot_floats = Shape::slot_floats(!kResident);
  constexpr int kHRow = kResident ? C : C + 4;  // a bank row's floats
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int tiles = (B + kPagesTile - 1) / kPagesTile;  // tiles per bin
  const int rp = (R + kPagesRows - 1) / kPagesRows * kPagesRows;
  const int cw = (O + C - 1) / C * C;  // the columns of every pass
  float* banks = ring + S * slot_floats;  // resident: [n][pass][rp][C]
  const long long work = static_cast<long long>(K) * tiles;
  const int w0 = static_cast<int>(work * blockIdx.x / gridDim.x);
  const int w1 = static_cast<int>(work * (blockIdx.x + 1) / gridDim.x);

  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(full + 8 * i, kFullArrivals);
      mbar_init(empty + 8 * i, Shape::kConsumerWarps);
    }
    for (int i = 0; i < n; ++i) {
      mbar_init(bank_full + 8 * i, 32);
      mbar_init(bank_empty + 8 * i, Shape::kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int slot = 0;           // the ring slot of the next stage
  unsigned parity = 0;    // the parity of that slot's current use
  bool reuse = false;     // the ring has wrapped at least once
  unsigned fb = 0;        // fresh bins so far
  if (tid / 32 == Shape::kConsumerWarps) {  // the producer
    const size_t page_floats = static_cast<size_t>(K) * R * B;
    for (int wi = w0; wi < w1; ++wi) {
      const int k = wi / tiles;
      const int b0 = (wi - k * tiles) * kPagesTile;
      const int span = min(kPagesTile, B - b0);
      const bool load = kResident && (wi == w0 || (wi - 1) / tiles != k);
      fb += load;
      for (int o0 = 0; o0 < O; o0 += C) {
        for (int a = 0; a < n; ++a) {
          const float* hk = bank + (static_cast<size_t>(a) * K + k) * O * R;
          if (load && o0 == 0) {
            if (fb > 1) mbar_wait(bank_empty + 8 * a, fb & 1);
            load_bank<C>(banks + static_cast<size_t>(a) * rp * cw, hk, rp,
                         cw, O, R, lane);
            cp_async_arrive(bank_full + 8 * a);
          }
          for (int r0 = 0; r0 < R; r0 += kPagesRows) {
            if (reuse) mbar_wait(empty + 8 * slot, parity ^ 1);
            float* xs = ring + slot * slot_floats;
            const int rows = min(kPagesRows, R - r0);
            if (!kResident) {
              load_bank_stage<C>(xs + kPagesRows * kSlotRow, hk, r0, rows,
                                 o0, O, R, lane);
            }
            if (kPagesSplit == 2) {
              if (lane == 0) mbar_arrive_expect_tx(full + 8 * slot, 0);
              cp_async_arrive(full + 8 * slot);
            } else {
              load_rows(xs, pages.p[a], page_floats, k, r0, rows, b0, span,
                        R, B, lane, full + 8 * slot);
            }
            if (++slot == S) {
              slot = 0;
              parity ^= 1;
              reuse = true;
            }
          }
        }
      }
    }
    return;
  }

  const int cwarp = tid / 32;
  const int l0 = (cwarp % kLaneWarps) * kWarpLanes;  // the warp's first lane
  const int lt = l0 + (kAligned ? 4 * lane : lane);  // this thread's first
  const int col0 = (cwarp / kLaneWarps) * OCT;       // its first column
  for (int wi = w0; wi < w1; ++wi) {
    const int k = wi / tiles;
    const int b0 = (wi - k * tiles) * kPagesTile;
    const int span = min(kPagesTile, B - b0);
    const bool load = kResident && (wi == w0 || (wi - 1) / tiles != k);
    const bool release =
        kResident && (wi + 1 == w1 || (wi + 1) / tiles != k);
    const bool active = l0 < span;  // warp-uniform
    fb += load;
    for (int o0 = 0; o0 < O; o0 += C) {
      float part[4][OCT];
#pragma unroll
      for (int o = 0; o < OCT; ++o) {
#pragma unroll
        for (int j = 0; j < 4; ++j) part[j][o] = 0.0f;
      }
      for (int a = 0; a < n; ++a) {
        if (load && o0 == 0) mbar_wait(bank_full + 8 * a, (fb - 1) & 1);
        for (int r0 = 0; r0 < R; r0 += kPagesRows) {
          mbar_wait(full + 8 * slot, parity);
          if (active && kPagesSplit != 1) {
            const float* xs = ring + slot * slot_floats;
            const float4* hq = reinterpret_cast<const float4*>(
                (kResident ? banks + (a * cw + o0) * rp + r0 * C
                           : xs + kPagesRows * kSlotRow) +
                col0);
            xs += lt;
            const float *x0 = xs, *x1 = xs, *x2 = xs, *x3 = xs;
            if (!kAligned) {
              // Row u's shift: the float index of its first lane, mod 4.
              const unsigned row0 =
                  static_cast<unsigned>(
                      reinterpret_cast<uintptr_t>(pages.p[a]) / 4) +
                  (static_cast<unsigned>(k) * R + r0) *
                      static_cast<unsigned>(B) +
                  b0;
              const unsigned b = B;
              x0 += row0 & 3;
              x1 += (row0 + b) & 3;
              x2 += (row0 + 2 * b) & 3;
              x3 += (row0 + 3 * b) & 3;
            }
            mac_stage<OCT, kHRow, kAligned>(part, x0, x1, x2, x3, hq);
          }
          __syncwarp();  // the warp's reads of the stage are done
          if (lane == 0) mbar_arrive(empty + 8 * slot);
          if (++slot == S) {
            slot = 0;
            parity ^= 1;
          }
        }
        if (release && o0 + C >= O && lane == 0) {
          mbar_arrive(bank_empty + 8 * a);  // the bin's last read of it
        }
        // The running sum (p0 + p1) + ... in shared memory; after the last
        // page, part holds the finished sums.
        if (a + 1 < n) {
#pragma unroll
          for (int o = 0; o < OCT; ++o) {
            float4* sp = sums + o * kThreadsC + tid;
            float4 v = make_float4(part[0][o], part[1][o], part[2][o],
                                   part[3][o]);
            if (a > 0) {
              const float4 u = *sp;
              v = make_float4(u.x + v.x, u.y + v.y, u.z + v.z, u.w + v.w);
            }
            *sp = v;
#pragma unroll
            for (int j = 0; j < 4; ++j) part[j][o] = 0.0f;
          }
        } else if (a > 0) {
#pragma unroll
          for (int o = 0; o < OCT; ++o) {
            const float4 u = sums[o * kThreadsC + tid];
            part[0][o] = u.x + part[0][o];
            part[1][o] = u.y + part[1][o];
            part[2][o] = u.z + part[2][o];
            part[3][o] = u.w + part[3][o];
          }
        }
      }

      if (active) {
#pragma unroll
        for (int o = 0; o < OCT; ++o) {
          const int col = o0 + col0 + o;
          if (col < O) {
            float* y = out + (static_cast<size_t>(col) * K + k) * B + b0 + lt;
            if (kAligned) {
              if (lt < span) {
                *reinterpret_cast<float4*>(y) = make_float4(
                    part[0][o], part[1][o], part[2][o], part[3][o]);
              }
            } else {
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                if (lt + 32 * j < span) y[32 * j] = part[j][o];
              }
            }
          }
        }
      }
    }
  }
}

template <int C, bool kAligned, bool kResident>
cudaError_t launch_pages(const PagePtrs& pages, const float* bank, float* out,
                         int n, int K, int R, int B, int O, int stages,
                         size_t smem, cudaStream_t s) {
  using Shape = PagesShape<C>;
  auto kernel = mac_kmajor_pages_kernel<C, kAligned, kResident>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  // Persistent CTAs, as many as fit on the card at once, each walking its
  // own run of (bin, tile) work items, so a CTA's ring keeps loading
  // across items.
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, Shape::kThreads, smem);
  }
  if (err != cudaSuccess) return err;
  const long long work =
      static_cast<long long>(K) * ((B + kPagesTile - 1) / kPagesTile);
  if (work > INT32_MAX) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(
      std::min<long long>(work, static_cast<long long>(std::max(per_sm, 1)) * sms));
  kernel<<<grid, Shape::kThreads, smem, s>>>(pages, bank, out, n, K, R, B, O,
                                             stages);
  return cudaGetLastError();
}

// One launch of instance C. The n pages' banks stay resident when they fit
// beside a ring of at least 2 stages with kCtasPerSm CTAs per SM (the ring
// then takes the most stages that fit, up to kMaxStages: a 5.1 or 7.1
// input's three pages at M = 8, R = 96 or 128, keep a shallower ring); else
// they are streamed in the stages of the deepest ring that fits.
template <int C>
cudaError_t launch_pages_any(const PagePtrs& pages, const float* bank,
                             float* out, int n, int K, int R, int B, int O,
                             bool aligned, cudaStream_t s) {
  using Shape = PagesShape<C>;
  const size_t rp = (R + kPagesRows - 1) / kPagesRows * kPagesRows;
  const size_t cw = (O + C - 1) / C * C;
  const size_t budget = kSmPerSm / Shape::kCtasPerSm - kSmemReserved;
  auto go = [&](auto resident, int stages, size_t smem) {
    constexpr bool kResident = decltype(resident)::value;
    return aligned ? launch_pages<C, true, kResident>(
                         pages, bank, out, n, K, R, B, O, stages, smem, s)
                   : launch_pages<C, false, kResident>(
                         pages, bank, out, n, K, R, B, O, stages, smem, s);
  };
  for (int stages = Shape::kMaxStages; stages >= 2; --stages) {
    const size_t smem = Shape::head_bytes(stages, n) +
                        sizeof(float) * (stages * Shape::slot_floats(false) +
                                         n * rp * cw);
    if (smem <= budget) return go(std::true_type{}, stages, smem);
  }
  for (int stages = Shape::kMaxStages; stages >= 2; --stages) {
    const size_t smem = Shape::head_bytes(stages, n) +
                        sizeof(float) * stages * Shape::slot_floats(true);
    if (smem <= budget) return go(std::false_type{}, stages, smem);
  }
  return cudaErrorInvalidValue;
}

// Makes `device` the thread's current device for a launch and restores the
// caller's device when it leaves scope: a launch on another card leaves the
// caller where it was (a pool's shard on cuda:1 must not move the
// process's later work off cuda:0).
class DeviceScope {
 public:
  explicit DeviceScope(int device) {
    if (cudaGetDevice(&previous_) != cudaSuccess) previous_ = -1;
    status_ = previous_ == device ? cudaSuccess : cudaSetDevice(device);
  }
  ~DeviceScope() {
    if (previous_ >= 0 && status_ == cudaSuccess) cudaSetDevice(previous_);
  }
  DeviceScope(const DeviceScope&) = delete;
  DeviceScope& operator=(const DeviceScope&) = delete;
  cudaError_t status() const { return status_; }

 private:
  int previous_ = -1;
  cudaError_t status_ = cudaSuccess;
};

}  // namespace

// Launches on `stream` (PyTorch's current stream) and returns
// cudaGetLastError() as an int: 0 means the launch was accepted. The caller
// validates shapes, dtypes, contiguity and the shared-memory size. `generic`
// nonzero runs the generic kernel whatever O is (the A/B of a dispatch
// change).
extern "C" int airwave_mac_kmajor(const float* fdl, const float* h, float* out,
                                  int K, int R, int B, int O, int accumulate,
                                  int generic, int device, void* stream) {
  const DeviceScope scope(device);
  if (scope.status() != cudaSuccess) return static_cast<int>(scope.status());
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
    case 12:
      mac_kmajor_fixed<12><<<grid, kThreads, smem, s>>>(fdl, h, out, K, R, B,
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

// pages: n (1..32) device pointers to [K, R, B], any 4-byte-aligned bases;
// launches on `stream` and returns cudaGetLastError() as an int, as
// airwave_mac_kmajor does. `columns`, the columns per pass over the pages,
// is 16, 32, 48 or 64 (the caller picks it by O).
extern "C" int airwave_mac_kmajor_pages(const float* const* pages, int n,
                                        const float* bank, float* out, int K,
                                        int R, int B, int O, int columns,
                                        int device, void* stream) {
  if (n < 1 || n > kMaxPages) return static_cast<int>(cudaErrorInvalidValue);
  const DeviceScope scope(device);
  if (scope.status() != cudaSuccess) return static_cast<int>(scope.status());
  cudaError_t err = cudaSuccess;
  PagePtrs p{};
  // Every row 16-byte aligned, and every float4 of out: the float4 route.
  bool aligned = B % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  for (int a = 0; a < n; ++a) {
    p.p[a] = pages[a];
    aligned = aligned && reinterpret_cast<uintptr_t>(pages[a]) % 16 == 0;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (columns) {
    case 16:
      err = launch_pages_any<16>(p, bank, out, n, K, R, B, O, aligned, s);
      break;
    case 32:
      err = launch_pages_any<32>(p, bank, out, n, K, R, B, O, aligned, s);
      break;
    case 48:
      err = launch_pages_any<48>(p, bank, out, n, K, R, B, O, aligned, s);
      break;
    case 64:
      err = launch_pages_any<64>(p, bank, out, n, K, R, B, O, aligned, s);
      break;
    default:
      err = cudaErrorInvalidValue;
      break;
  }
  return static_cast<int>(err);
}

extern "C" const char* airwave_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
