// Native host runtime for resampler_tpu.
//
// The device holds the compute path (XLA programs); this library is the
// native runtime *around* it — the role the reference crate's Rust code
// plays for its SIMD kernels' host side: audio file IO, interleave layout
// conversion, and multi-stream staging for batched device steps
// (reference analogs: resample/src/main.rs:85-156 WAV decode/normalize,
// src/resampler_fir.rs:524-538 deinterleave copy-in, SURVEY.md §2.9
// instance parallelism).
//
// Build: make -C csrc   ->  csrc/build/libresampler_host.so
// ABI: plain C, used from Python via ctypes (resampler_tpu/utils/native.py).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <new>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// memory
// ---------------------------------------------------------------------------

void rtpu_free(void* p) { std::free(p); }

// ---------------------------------------------------------------------------
// interleave layout conversion
// [frames*channels] interleaved <-> [channels][frames] planar
// ---------------------------------------------------------------------------

void rtpu_deinterleave(const float* in, float* out, uint64_t frames,
                       uint32_t channels) {
  // out[c*frames + i] = in[i*channels + c]
  for (uint32_t c = 0; c < channels; ++c) {
    float* dst = out + (uint64_t)c * frames;
    const float* src = in + c;
    for (uint64_t i = 0; i < frames; ++i) {
      dst[i] = src[(uint64_t)i * channels];
    }
  }
}

void rtpu_interleave(const float* in, float* out, uint64_t frames,
                     uint32_t channels) {
  for (uint32_t c = 0; c < channels; ++c) {
    const float* src = in + (uint64_t)c * frames;
    float* dst = out + c;
    for (uint64_t i = 0; i < frames; ++i) {
      dst[(uint64_t)i * channels] = src[i];
    }
  }
}

// ---------------------------------------------------------------------------
// WAV (RIFF) codec: PCM 8/16/24/32 + IEEE float32 -> normalized f32
// ---------------------------------------------------------------------------

namespace {

struct Reader {
  const uint8_t* p;
  size_t n;
  size_t pos = 0;
  bool read(void* dst, size_t k) {
    if (pos + k > n) return false;
    std::memcpy(dst, p + pos, k);
    pos += k;
    return true;
  }
  bool skip(size_t k) {
    if (pos + k > n) return false;
    pos += k;
    return true;
  }
};

uint32_t rd_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
uint16_t rd_u16(const uint8_t* p) {
  return (uint16_t)((uint16_t)p[0] | ((uint16_t)p[1] << 8));
}

}  // namespace

// Returns 0 on success. Caller frees *out_samples with rtpu_free.
// *format_code: 1 = PCM int, 3 = IEEE float (after EXTENSIBLE resolution).
int rtpu_wav_read(const char* path, float** out_samples, uint64_t* n_samples,
                  uint32_t* sample_rate, uint16_t* channels,
                  uint16_t* bits_per_sample, uint16_t* format_code) {
  *out_samples = nullptr;
  *n_samples = 0;

  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long fsize = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (fsize < 12) {
    std::fclose(f);
    return -2;
  }
  std::vector<uint8_t> data((size_t)fsize);
  size_t got = std::fread(data.data(), 1, (size_t)fsize, f);
  std::fclose(f);
  if (got != (size_t)fsize) return -3;

  if (std::memcmp(data.data(), "RIFF", 4) != 0 ||
      std::memcmp(data.data() + 8, "WAVE", 4) != 0)
    return -2;

  const uint8_t* fmt = nullptr;
  size_t fmt_size = 0;
  const uint8_t* raw = nullptr;
  size_t raw_size = 0;
  size_t pos = 12;
  while (pos + 8 <= data.size()) {
    const uint8_t* id = data.data() + pos;
    uint32_t sz = rd_u32(data.data() + pos + 4);
    if (pos + 8 + sz > data.size()) sz = (uint32_t)(data.size() - pos - 8);
    if (std::memcmp(id, "fmt ", 4) == 0) {
      fmt = data.data() + pos + 8;
      fmt_size = sz;
    } else if (std::memcmp(id, "data", 4) == 0) {
      raw = data.data() + pos + 8;
      raw_size = sz;
    }
    pos += 8 + sz + (sz & 1);  // word aligned
  }
  if (!fmt || fmt_size < 16 || !raw) return -2;

  uint16_t format = rd_u16(fmt);
  uint16_t ch = rd_u16(fmt + 2);
  uint32_t rate = rd_u32(fmt + 4);
  uint16_t bits = rd_u16(fmt + 14);
  if (format == 0xFFFE && fmt_size >= 26) format = rd_u16(fmt + 24);
  if (ch == 0) return -4;

  uint64_t count;
  float* out;
  if (format == 3) {  // IEEE float
    if (bits != 32) return -5;
    count = raw_size / 4;
    out = (float*)std::malloc(count * sizeof(float));
    if (!out) return -6;
    std::memcpy(out, raw, count * 4);
  } else if (format == 1) {  // PCM int, normalize by 2^(bits-1)
    switch (bits) {
      case 8: {
        count = raw_size;
        out = (float*)std::malloc(count * sizeof(float));
        if (!out) return -6;
        const float s = 1.0f / 128.0f;
        for (uint64_t i = 0; i < count; ++i)
          out[i] = ((int32_t)raw[i] - 128) * s;
        break;
      }
      case 16: {
        count = raw_size / 2;
        out = (float*)std::malloc(count * sizeof(float));
        if (!out) return -6;
        const float s = 1.0f / 32768.0f;
        for (uint64_t i = 0; i < count; ++i) {
          int16_t v;
          std::memcpy(&v, raw + 2 * i, 2);
          out[i] = v * s;
        }
        break;
      }
      case 24: {
        count = raw_size / 3;
        out = (float*)std::malloc(count * sizeof(float));
        if (!out) return -6;
        const float s = 1.0f / 8388608.0f;
        for (uint64_t i = 0; i < count; ++i) {
          const uint8_t* b = raw + 3 * i;
          int32_t v = (int32_t)((uint32_t)b[0] | ((uint32_t)b[1] << 8) |
                                ((uint32_t)b[2] << 16));
          v = (v << 8) >> 8;  // sign extend
          out[i] = v * s;
        }
        break;
      }
      case 32: {
        count = raw_size / 4;
        out = (float*)std::malloc(count * sizeof(float));
        if (!out) return -6;
        const double s = 1.0 / 2147483648.0;
        for (uint64_t i = 0; i < count; ++i) {
          int32_t v;
          std::memcpy(&v, raw + 4 * i, 4);
          out[i] = (float)(v * s);
        }
        break;
      }
      default:
        return -5;
    }
  } else {
    return -5;
  }

  // whole frames only
  count -= count % ch;
  *out_samples = out;
  *n_samples = count;
  *sample_rate = rate;
  *channels = ch;
  *bits_per_sample = bits;
  *format_code = format;
  return 0;
}

// Write 32-bit IEEE-float WAV. Returns 0 on success.
int rtpu_wav_write(const char* path, const float* samples, uint64_t n,
                   uint32_t sample_rate, uint16_t channels) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  uint32_t data_bytes = (uint32_t)(n * 4);
  uint32_t byte_rate = sample_rate * channels * 4;
  uint16_t block_align = (uint16_t)(channels * 4);
  uint8_t hdr[44];
  std::memcpy(hdr, "RIFF", 4);
  uint32_t riff = 36 + data_bytes;
  std::memcpy(hdr + 4, &riff, 4);
  std::memcpy(hdr + 8, "WAVEfmt ", 8);
  uint32_t fmt_size = 16;
  std::memcpy(hdr + 16, &fmt_size, 4);
  uint16_t fmt_tag = 3;  // IEEE float
  std::memcpy(hdr + 20, &fmt_tag, 2);
  std::memcpy(hdr + 22, &channels, 2);
  std::memcpy(hdr + 24, &sample_rate, 4);
  std::memcpy(hdr + 28, &byte_rate, 4);
  std::memcpy(hdr + 32, &block_align, 2);
  uint16_t bits = 32;
  std::memcpy(hdr + 34, &bits, 2);
  std::memcpy(hdr + 36, "data", 4);
  std::memcpy(hdr + 40, &data_bytes, 4);
  bool ok = std::fwrite(hdr, 1, 44, f) == 44 &&
            std::fwrite(samples, 4, n, f) == n;
  std::fclose(f);
  return ok ? 0 : -3;
}

// ---------------------------------------------------------------------------
// Multi-stream staging pool: ragged per-stream FIFO queues of interleaved
// audio, drained into fixed-shape [n_streams, chunk_frames, channels]
// batches + per-stream valid counts for the batched device step.  This is
// the host-side "data loader" for fleet serving; thread-safe pushes.
// ---------------------------------------------------------------------------

struct StreamQueue {
  std::vector<float> buf;  // interleaved
  size_t head = 0;         // values consumed
  std::mutex mu;

  size_t pending_values() {
    std::lock_guard<std::mutex> g(mu);
    return buf.size() - head;
  }
};

struct rtpu_pool {
  uint32_t n_streams;
  uint32_t channels;
  uint32_t capacity_frames;  // max frames queued per stream
  std::vector<StreamQueue> queues;
};

rtpu_pool* rtpu_pool_create(uint32_t n_streams, uint32_t channels,
                            uint32_t capacity_frames) {
  if (n_streams == 0 || channels == 0 || capacity_frames == 0) return nullptr;
  auto* p = new (std::nothrow) rtpu_pool;
  if (!p) return nullptr;
  p->n_streams = n_streams;
  p->channels = channels;
  p->capacity_frames = capacity_frames;
  p->queues = std::vector<StreamQueue>(n_streams);
  return p;
}

void rtpu_pool_destroy(rtpu_pool* p) { delete p; }

// Push interleaved values onto stream's queue; returns values accepted
// (multiple of channels; bounded by per-stream capacity) or -1 on error.
int64_t rtpu_pool_push(rtpu_pool* p, uint32_t stream, const float* values,
                       uint64_t n_values) {
  if (!p || stream >= p->n_streams) return -1;
  n_values -= n_values % p->channels;
  StreamQueue& q = p->queues[stream];
  std::lock_guard<std::mutex> g(q.mu);
  uint64_t pending = q.buf.size() - q.head;
  uint64_t cap_values = (uint64_t)p->capacity_frames * p->channels;
  uint64_t room = pending >= cap_values ? 0 : cap_values - pending;
  uint64_t take = n_values < room ? n_values : room;
  take -= take % p->channels;
  // compact lazily when the dead prefix dominates
  if (q.head > q.buf.size() / 2 && q.head > 4096) {
    q.buf.erase(q.buf.begin(), q.buf.begin() + (long)q.head);
    q.head = 0;
  }
  q.buf.insert(q.buf.end(), values, values + take);
  return (int64_t)take;
}

uint64_t rtpu_pool_pending(rtpu_pool* p, uint32_t stream) {
  if (!p || stream >= p->n_streams) return 0;
  return p->queues[stream].pending_values();
}

// Drain up to chunk_frames frames per stream into a frames-major batch
// [n_streams, chunk_frames, channels] (zero-padded) and per-stream valid
// frame counts. The batch layout matches the batched device step input.
void rtpu_pool_fill(rtpu_pool* p, float* batch, int32_t* n_valid,
                    uint32_t chunk_frames) {
  if (!p) return;
  const uint32_t C = p->channels;
  const uint64_t stride = (uint64_t)chunk_frames * C;
  for (uint32_t s = 0; s < p->n_streams; ++s) {
    StreamQueue& q = p->queues[s];
    std::lock_guard<std::mutex> g(q.mu);
    uint64_t pending = q.buf.size() - q.head;
    uint64_t frames = pending / C;
    if (frames > chunk_frames) frames = chunk_frames;
    float* dst = batch + (uint64_t)s * stride;
    std::memcpy(dst, q.buf.data() + q.head, frames * C * sizeof(float));
    std::memset(dst + frames * C, 0, (stride - frames * C) * sizeof(float));
    q.head += frames * C;
    n_valid[s] = (int32_t)frames;
  }
}

// ---------------------------------------------------------------------------
// version / self-test hooks
// ---------------------------------------------------------------------------

uint32_t rtpu_abi_version(void) { return 1; }

}  // extern "C"
