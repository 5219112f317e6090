// Native audio I/O for aid_tpu_torch: WAV decode with random-access segment
// reads, WAV write, and libsoxr-backed resampling.
//
// The port's own copy of the JAX package's audioio.cpp (the same code, so
// both packages read, write and resample sample for sample alike), plus
// aio_soxr_loaded. The training-loader hot path is aio_read_segment: open ->
// seek -> decode only the requested window, so an 8-segment draw from a
// 40-minute performance file never touches the rest of the file. All entry
// points are plain C ABI for ctypes.
//
// Build: aid_tpu_torch/data/audio_io.py compiles this file and flac.cpp with
// g++ -O2 -shared -fPIC ... -ldl at first use.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <dlfcn.h>

namespace {

#pragma pack(push, 1)
struct RiffHeader {
  char riff[4];
  uint32_t size;
  char wave[4];
};
struct ChunkHeader {
  char id[4];
  uint32_t size;
};
struct FmtChunk {
  uint16_t format;        // 1 = PCM, 3 = IEEE float, 0xFFFE = extensible
  uint16_t channels;
  uint32_t sample_rate;
  uint32_t byte_rate;
  uint16_t block_align;
  uint16_t bits;
};
#pragma pack(pop)

struct WavInfo {
  long data_offset = 0;   // byte offset of sample data
  long data_bytes = 0;
  int channels = 0;
  int sample_rate = 0;
  int bits = 0;
  int is_float = 0;
  long frames = 0;
};

// Parse RIFF chunks until 'data'; leaves file usable for seeking.
bool parse_wav(FILE* f, WavInfo* out) {
  RiffHeader rh;
  if (fread(&rh, sizeof rh, 1, f) != 1) return false;
  if (memcmp(rh.riff, "RIFF", 4) != 0 || memcmp(rh.wave, "WAVE", 4) != 0)
    return false;
  bool have_fmt = false;
  for (;;) {
    ChunkHeader ch;
    if (fread(&ch, sizeof ch, 1, f) != 1) return false;
    if (memcmp(ch.id, "fmt ", 4) == 0) {
      FmtChunk fmt;
      size_t take = ch.size < sizeof fmt ? ch.size : sizeof fmt;
      if (fread(&fmt, take, 1, f) != 1) return false;
      if (ch.size > take && fseek(f, ch.size - take, SEEK_CUR) != 0) return false;
      uint16_t format = fmt.format;
      if (format == 0xFFFE) format = 1;  // extensible: assume PCM subformat
      out->channels = fmt.channels;
      out->sample_rate = fmt.sample_rate;
      out->bits = fmt.bits;
      out->is_float = (format == 3) ? 1 : 0;
      if (format != 1 && format != 3) return false;
      have_fmt = true;
    } else if (memcmp(ch.id, "data", 4) == 0) {
      if (!have_fmt) return false;
      out->data_offset = ftell(f);
      out->data_bytes = ch.size;
      long bytes_per_frame = (long)out->channels * (out->bits / 8);
      if (bytes_per_frame <= 0) return false;
      out->frames = out->data_bytes / bytes_per_frame;
      return true;
    } else {
      // chunk sizes are word-aligned
      long skip = ch.size + (ch.size & 1);
      if (fseek(f, skip, SEEK_CUR) != 0) return false;
    }
  }
}

inline float decode_sample(const uint8_t* p, int bits, int is_float) {
  if (is_float) {
    if (bits == 32) { float v; memcpy(&v, p, 4); return v; }
    double v; memcpy(&v, p, 8); return (float)v;
  }
  switch (bits) {
    case 16: {
      int16_t v; memcpy(&v, p, 2);
      return (float)v / 32768.0f;
    }
    case 24: {
      int32_t v = (int32_t)p[0] | ((int32_t)p[1] << 8) | ((int32_t)p[2] << 16);
      if (v & 0x800000) v -= 0x1000000;
      return (float)v / 8388608.0f;
    }
    case 32: {
      int32_t v; memcpy(&v, p, 4);
      return (float)v / 2147483648.0f;
    }
    case 8:
      return ((float)p[0] - 128.0f) / 128.0f;
    default:
      return 0.0f;
  }
}

}  // namespace

extern "C" {

// -> 0 on success
int aio_read_info(const char* path, long* frames, int* sample_rate,
                  int* channels) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo wi;
  bool ok = parse_wav(f, &wi);
  fclose(f);
  if (!ok) return -2;
  *frames = wi.frames;
  *sample_rate = wi.sample_rate;
  *channels = wi.channels;
  return 0;
}

// Decode `frames` frames starting at frame `start` into out[0..frames),
// mono-mixed float32. Returns frames actually read, or <0 on error.
long aio_read_segment(const char* path, long start, long frames, float* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo wi;
  if (!parse_wav(f, &wi)) { fclose(f); return -2; }
  int bpf_sample = wi.bits / 8;
  long bytes_per_frame = (long)wi.channels * bpf_sample;
  if (start < 0) start = 0;
  if (start > wi.frames) start = wi.frames;
  long n = frames;
  if (start + n > wi.frames) n = wi.frames - start;
  if (n <= 0) { fclose(f); return 0; }
  if (fseek(f, wi.data_offset + start * bytes_per_frame, SEEK_SET) != 0) {
    fclose(f); return -3;
  }
  const long kChunk = 1 << 16;  // frames per read
  uint8_t* buf = (uint8_t*)malloc(kChunk * bytes_per_frame);
  if (!buf) { fclose(f); return -4; }
  long done = 0;
  float inv_ch = 1.0f / (float)wi.channels;
  while (done < n) {
    long want = n - done < kChunk ? n - done : kChunk;
    long got = (long)fread(buf, bytes_per_frame, want, f);
    if (got <= 0) break;
    for (long i = 0; i < got; ++i) {
      const uint8_t* fr = buf + i * bytes_per_frame;
      float acc = 0.0f;
      for (int c = 0; c < wi.channels; ++c)
        acc += decode_sample(fr + c * bpf_sample, wi.bits, wi.is_float);
      out[done + i] = acc * inv_ch;
    }
    done += got;
  }
  free(buf);
  fclose(f);
  return done;
}

// Write mono float32 as 16-bit PCM WAV. -> 0 on success.
int aio_write_wav(const char* path, const float* audio, long frames, int fs) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  uint32_t data_bytes = (uint32_t)(frames * 2);
  RiffHeader rh{{'R','I','F','F'}, 36 + data_bytes, {'W','A','V','E'}};
  ChunkHeader fmt_h{{'f','m','t',' '}, 16};
  FmtChunk fmt{1, 1, (uint32_t)fs, (uint32_t)fs * 2, 2, 16};
  ChunkHeader data_h{{'d','a','t','a'}, data_bytes};
  fwrite(&rh, sizeof rh, 1, f);
  fwrite(&fmt_h, sizeof fmt_h, 1, f);
  fwrite(&fmt, sizeof fmt, 1, f);
  fwrite(&data_h, sizeof data_h, 1, f);
  const long kChunk = 1 << 16;
  int16_t* buf = (int16_t*)malloc(kChunk * 2);
  if (!buf) { fclose(f); return -2; }
  long done = 0;
  while (done < frames) {
    long want = frames - done < kChunk ? frames - done : kChunk;
    for (long i = 0; i < want; ++i) {
      float v = audio[done + i];
      if (v > 1.0f) v = 1.0f;
      if (v < -1.0f) v = -1.0f;
      buf[i] = (int16_t)(v * 32767.0f);
    }
    fwrite(buf, 2, want, f);
    done += want;
  }
  free(buf);
  fclose(f);
  return 0;
}

typedef void* (*soxr_oneshot_t)(double, double, unsigned,
                                const void*, size_t, size_t*,
                                void*, size_t, size_t*,
                                const void*, const void*, const void*);

static soxr_oneshot_t soxr_oneshot_fn() {
  static void* handle = dlopen("libsoxr.so.0", RTLD_NOW | RTLD_GLOBAL);
  if (!handle) return nullptr;
  static soxr_oneshot_t oneshot =
      (soxr_oneshot_t)dlsym(handle, "soxr_oneshot");
  return oneshot;
}

// 1 when libsoxr loads and exports soxr_oneshot, else 0.
int aio_soxr_loaded() { return soxr_oneshot_fn() ? 1 : 0; }

// libsoxr one-shot resampling (dlopen'd so the .so loads without soxr too).
// Returns output frames written, or <0 if soxr is unavailable/failed.
long aio_resample(const float* in, long in_len, float* out, long out_cap,
                  double fs_in, double fs_out) {
  soxr_oneshot_t oneshot = soxr_oneshot_fn();
  if (!oneshot) return -1;
  size_t idone = 0, odone = 0;
  void* err = oneshot(fs_in, fs_out, 1, in, (size_t)in_len, &idone,
                      out, (size_t)out_cap, &odone, nullptr, nullptr, nullptr);
  if (err) return -3;
  return (long)odone;
}

}  // extern "C"
