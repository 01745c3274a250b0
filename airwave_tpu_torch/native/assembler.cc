// Ragged per-stream frame assembler — the native host data plane.
//
// The reference keeps its realtime path allocation-free with preallocated
// ring buffers in Swift (Airwave/RealtimeAudioProcessor.swift:30-190).
// The TPU framework's host-side equivalent problem is harder: thousands of
// independent streams deliver ragged chunks (arbitrary sizes, arbitrary
// arrival order) and the device wants dense [batch, channels, block] steps.
// This C++ core owns per-stream input rings, harvests dense batches of
// block-complete streams, and scatters rendered output back into per-stream
// output rings with the reference's underflow-zero-fill drain contract.
//
// Exposed as a plain C ABI for ctypes; all buffers are caller-provided
// float32 (channel-major [C, n] chunks; harvest writes [k, C, block]).

#include <cstdint>
#include <cstring>
#include <new>
#include <vector>

namespace {

struct Ring {
  std::vector<float> data;  // [channels][capacity] planes
  int64_t read = 0;         // absolute read cursor
  int64_t count = 0;        // buffered frames

  void init(int channels, int capacity) {
    data.assign(static_cast<size_t>(channels) * capacity, 0.0f);
  }
};

struct Assembler {
  int n_streams;
  int channels;
  int block;
  int capacity;
  std::vector<Ring> input;
  std::vector<Ring> output;
};

inline float* plane(Assembler* a, Ring& r, int channel) {
  return r.data.data() + static_cast<size_t>(channel) * a->capacity;
}

// Copy `frames` frames from channel-major src[C, frames] into the ring.
int ring_push(Assembler* a, Ring& r, const float* src, int frames) {
  if (frames <= 0) return 0;
  if (r.count + frames > a->capacity) return -1;  // overflow refused
  int64_t write = (r.read + r.count) % a->capacity;
  for (int c = 0; c < a->channels; ++c) {
    float* dst = plane(a, r, c);
    const float* s = src + static_cast<size_t>(c) * frames;
    int64_t w = write;
    int first = static_cast<int>(
        frames < a->capacity - w ? frames : a->capacity - w);
    std::memcpy(dst + w, s, sizeof(float) * first);
    if (first < frames) {
      std::memcpy(dst, s + first, sizeof(float) * (frames - first));
    }
  }
  r.count += frames;
  return 0;
}

// Pop up to `frames` frames into channel-major dst[C, frames]; zero-fill the
// shortfall (the reference's deliberate underflow contract). Returns the
// number of real (non-zero-filled) frames.
int ring_pop(Assembler* a, Ring& r, float* dst, int frames) {
  if (frames <= 0) return 0;
  int available = static_cast<int>(r.count < frames ? r.count : frames);
  for (int c = 0; c < a->channels; ++c) {
    const float* src = plane(a, r, c);
    float* d = dst + static_cast<size_t>(c) * frames;
    int64_t read = r.read;
    int first = static_cast<int>(
        available < a->capacity - read ? available : a->capacity - read);
    std::memcpy(d, src + read, sizeof(float) * first);
    if (first < available) {
      std::memcpy(d + first, src, sizeof(float) * (available - first));
    }
    if (available < frames) {
      std::memset(d + available, 0, sizeof(float) * (frames - available));
    }
  }
  r.read = (r.read + available) % a->capacity;
  r.count -= available;
  return available;
}

}  // namespace

extern "C" {

Assembler* awv_create(int n_streams, int channels, int block, int capacity) {
  if (n_streams <= 0 || channels <= 0 || block <= 0 || capacity < block) {
    return nullptr;
  }
  auto* a = new (std::nothrow) Assembler();
  if (!a) return nullptr;
  a->n_streams = n_streams;
  a->channels = channels;
  a->block = block;
  a->capacity = capacity;
  a->input.resize(n_streams);
  a->output.resize(n_streams);
  for (int i = 0; i < n_streams; ++i) {
    a->input[i].init(channels, capacity);
    a->output[i].init(channels, capacity);
  }
  return a;
}

void awv_destroy(Assembler* a) { delete a; }

int awv_push(Assembler* a, int stream, const float* data, int frames) {
  if (!a || stream < 0 || stream >= a->n_streams) return -2;
  return ring_push(a, a->input[stream], data, frames);
}

int awv_pending(Assembler* a, int stream) {
  if (!a || stream < 0 || stream >= a->n_streams) return -2;
  return static_cast<int>(a->input[stream].count);
}

int awv_ready_count(Assembler* a) {
  if (!a) return -2;
  int ready = 0;
  for (auto& r : a->input) {
    if (r.count >= a->block) ++ready;
  }
  return ready;
}

// Harvest up to max_batch block-complete streams (lowest stream id first).
// indices: int32[max_batch]; out: float32[max_batch, channels, block].
// Consumes one block per harvested stream. Returns the harvested count.
int awv_harvest(Assembler* a, int max_batch, int32_t* indices, float* out) {
  if (!a || max_batch <= 0) return -2;
  int k = 0;
  const size_t stride = static_cast<size_t>(a->channels) * a->block;
  for (int i = 0; i < a->n_streams && k < max_batch; ++i) {
    Ring& r = a->input[i];
    if (r.count < a->block) continue;
    ring_pop(a, r, out + k * stride, a->block);
    indices[k] = i;
    ++k;
  }
  return k;
}

// Harvest like awv_harvest, but only from streams with allow[stream] != 0.
// The serving pool passes the output side's free-space mask so a stream
// with a full output ring is simply not harvested — backpressure then
// propagates to the producer through the input ring instead of surfacing
// as an overflow after rendering.
// Harvest like awv_harvest, restricted to streams with allow[stream] != 0,
// popping `frames` frames per stream (streams with fewer buffered frames
// are skipped). The serving pool passes the output side's free-space mask
// so a stream with a full output ring is simply not harvested —
// backpressure then propagates to the producer through the input ring
// instead of surfacing as an overflow after rendering. The multi-block
// serving tier harvests frames = M * block per round.
int awv_harvest_allowed_n(Assembler* a, int max_batch, int frames,
                          const int32_t* allow, int32_t* indices,
                          float* out) {
  if (!a || max_batch <= 0 || frames <= 0 || !allow) return -2;
  int k = 0;
  const size_t stride = static_cast<size_t>(a->channels) * frames;
  for (int i = 0; i < a->n_streams && k < max_batch; ++i) {
    if (!allow[i]) continue;
    Ring& r = a->input[i];
    if (r.count < frames) continue;
    ring_pop(a, r, out + k * stride, frames);
    indices[k] = i;
    ++k;
  }
  return k;
}

int awv_harvest_allowed(Assembler* a, int max_batch, const int32_t* allow,
                        int32_t* indices, float* out) {
  if (!a) return -2;
  return awv_harvest_allowed_n(a, max_batch, a->block, allow, indices, out);
}

// Per-stream output-ring free space (frames), one call for the whole pool.
int awv_out_free_all(Assembler* a, int32_t* out) {
  if (!a || !out) return -2;
  for (int i = 0; i < a->n_streams; ++i) {
    out[i] = a->capacity - static_cast<int>(a->output[i].count);
  }
  return 0;
}

// Scatter rendered blocks back: indices/int32[k], data float32[k, C, block].
// All-or-nothing: free space is verified for every target before any write,
// so a -1 return means NO ring was modified (callers may safely fall back
// to per-stream delivery without duplicating blocks).
// Scatter `frames` frames per stream (the multi-block tier delivers
// M * block at once; the single-block pool passes block).
int awv_scatter_out_n(Assembler* a, int k, int frames,
                      const int32_t* indices, const float* data) {
  if (!a || k < 0 || frames <= 0) return -2;
  std::vector<int64_t> extra(a->n_streams, 0);  // duplicate-id aware
  for (int j = 0; j < k; ++j) {
    int stream = indices[j];
    if (stream < 0 || stream >= a->n_streams) return -2;
    if (a->output[stream].count + extra[stream] + frames > a->capacity) {
      return -1;
    }
    extra[stream] += frames;
  }
  const size_t stride = static_cast<size_t>(a->channels) * frames;
  for (int j = 0; j < k; ++j) {
    ring_push(a, a->output[indices[j]], data + j * stride, frames);
  }
  return 0;
}

int awv_scatter_out(Assembler* a, int k, const int32_t* indices,
                    const float* data) {
  if (!a) return -2;
  if (k == 0) return 0;
  return awv_scatter_out_n(a, k, a->block, indices, data);
}

int awv_push_out(Assembler* a, int stream, const float* data, int frames) {
  if (!a || stream < 0 || stream >= a->n_streams) return -2;
  return ring_push(a, a->output[stream], data, frames);
}

int awv_pop_out(Assembler* a, int stream, float* out, int frames) {
  if (!a || stream < 0 || stream >= a->n_streams) return -2;
  return ring_pop(a, a->output[stream], out, frames);
}

int awv_out_available(Assembler* a, int stream) {
  if (!a || stream < 0 || stream >= a->n_streams) return -2;
  return static_cast<int>(a->output[stream].count);
}

// Batch push: data float32[k, C, frames], one chunk per stream, all the
// same length. All-or-nothing (like awv_scatter_out): capacity is checked
// for every stream before any write, so -1 means NO ring was modified.
int awv_push_many(Assembler* a, int k, const int32_t* streams,
                  const float* data, int frames) {
  if (!a || k < 0 || frames < 0) return -2;
  if (k == 0 || frames == 0) return 0;
  // Capacity pre-check must account for DUPLICATE stream ids within the
  // batch (each occurrence adds `frames`), or the all-or-nothing
  // guarantee breaks on the second occurrence.
  std::vector<int64_t> extra(a->n_streams, 0);
  for (int j = 0; j < k; ++j) {
    int s = streams[j];
    if (s < 0 || s >= a->n_streams) return -2;
    if (a->input[s].count + extra[s] + frames > a->capacity) return -1;
    extra[s] += frames;
  }
  const size_t stride = static_cast<size_t>(a->channels) * frames;
  for (int j = 0; j < k; ++j) {
    ring_push(a, a->input[streams[j]], data + j * stride, frames);
  }
  return 0;
}

// Batch drain: out float32[k, C, frames], zero-filled per stream on
// underflow (the reference contract). One call replaces k pop loops.
int awv_pop_out_many(Assembler* a, int k, const int32_t* streams,
                     float* out, int frames) {
  if (!a || k < 0 || frames < 0) return -2;
  if (k == 0 || frames == 0) return 0;
  // Validate every id BEFORE draining anything: a bad id mid-batch must
  // not consume earlier streams' rendered audio irrecoverably.
  for (int j = 0; j < k; ++j) {
    if (streams[j] < 0 || streams[j] >= a->n_streams) return -2;
  }
  const size_t stride = static_cast<size_t>(a->channels) * frames;
  for (int j = 0; j < k; ++j) {
    ring_pop(a, a->output[streams[j]], out + j * stride, frames);
  }
  return 0;
}

int awv_reset_stream(Assembler* a, int stream) {
  if (!a || stream < 0 || stream >= a->n_streams) return -2;
  a->input[stream].read = a->input[stream].count = 0;
  a->output[stream].read = a->output[stream].count = 0;
  return 0;
}

}  // extern "C"
