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

#include <cuda_runtime.h>

#include <cstddef>

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

}  // namespace

// Launches on `stream` (PyTorch's current stream) and returns
// cudaGetLastError() as an int: 0 means the launch was accepted. The caller
// validates shapes, dtypes, contiguity and the shared-memory size.
extern "C" int airwave_mac_kmajor(const float* fdl, const float* h, float* out,
                                  int K, int R, int B, int O, int accumulate,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((B + kThreads - 1) / kThreads, K);
  const size_t smem = static_cast<size_t>(O) * R * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (O) {
    case 4:
      mac_kmajor_fixed<4><<<grid, kThreads, smem, s>>>(fdl, h, out, K, R, B,
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

extern "C" const char* airwave_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
