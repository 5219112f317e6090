// Native FLAC decoder for aid_tpu_torch (the port's own copy of the JAX
// package's flac.cpp, the same code).
//
// The reference reads the LibriSpeech corpus (.flac) through soundfile /
// libsndfile; neither libsndfile nor libFLAC is assumed present, so the
// package carries its own decoder. Full bitstream support: STREAMINFO, frame
// headers (CRC-8 verified, UTF-8 coded numbers, all block-size/sample-size
// codes), subframe types CONSTANT / VERBATIM / FIXED(0-4) / LPC(1-32), Rice &
// Rice2 residual partitions with escape codes, wasted bits, and left-side /
// right-side / mid-side stereo decorrelation. Output is mono-mixed float32,
// matching the WAV path in audioio.cpp. Plain C ABI for ctypes.
//
// Build: compiled with audioio.cpp into one library by
// aid_tpu_torch/data/audio_io.py at first use.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {

struct BitReader {
  const uint8_t* d;
  size_t n;
  size_t pos = 0;
  int bit = 0;  // bits consumed of d[pos], MSB first
  bool err = false;

  inline uint64_t read_bits(int k) {  // k <= 57
    uint64_t v = 0;
    while (k > 0) {
      if (pos >= n) { err = true; return 0; }
      int avail = 8 - bit;
      int take = k < avail ? k : avail;
      int shift = avail - take;
      v = (v << take) | ((d[pos] >> shift) & ((1u << take) - 1));
      bit += take;
      k -= take;
      if (bit == 8) { bit = 0; ++pos; }
    }
    return v;
  }

  inline int64_t read_signed(int k) {
    if (k <= 0) return 0;
    uint64_t v = read_bits(k);
    uint64_t sign = 1ull << (k - 1);
    return (int64_t)(v ^ sign) - (int64_t)sign;
  }

  inline uint32_t read_unary() {  // q zero-bits terminated by a one-bit
    uint32_t q = 0;
    for (;;) {
      if (pos >= n) { err = true; return q; }
      uint8_t rest = (uint8_t)(d[pos] << bit);
      if (rest == 0) {  // whole remaining byte is zeros
        q += 8 - bit;
        bit = 0;
        ++pos;
        continue;
      }
      // count leading zeros in the remaining bits of this byte
      int lz = 0;
      while (!((rest >> (7 - lz)) & 1)) ++lz;
      q += lz;
      bit += lz + 1;  // consume the zeros and the terminating one
      if (bit >= 8) { bit -= 8; ++pos; }
      return q;
    }
  }

  inline void align() {
    if (bit) { bit = 0; ++pos; }
  }
};

struct StreamInfo {
  uint32_t min_block = 0, max_block = 0;
  uint32_t sample_rate = 0;
  int channels = 0;
  int bits = 0;
  uint64_t total_samples = 0;  // 0 = unknown
  size_t first_frame = 0;      // byte offset of the first audio frame
};

uint8_t crc8(const uint8_t* p, size_t len) {  // poly x^8+x^2+x+1, init 0
  uint8_t c = 0;
  for (size_t i = 0; i < len; ++i) {
    c ^= p[i];
    for (int b = 0; b < 8; ++b)
      c = (uint8_t)((c & 0x80) ? (c << 1) ^ 0x07 : (c << 1));
  }
  return c;
}

uint16_t crc16(const uint8_t* p, size_t len) {  // poly x^16+x^15+x^2+1, init 0
  uint16_t c = 0;
  for (size_t i = 0; i < len; ++i) {
    c ^= (uint16_t)p[i] << 8;
    for (int b = 0; b < 8; ++b)
      c = (uint16_t)((c & 0x8000) ? (c << 1) ^ 0x8005 : (c << 1));
  }
  return c;
}

bool parse_streaminfo(const uint8_t* d, size_t n, StreamInfo* si) {
  size_t pos = 0;
  if (n >= 10 && memcmp(d, "ID3", 3) == 0) {  // skip leading ID3v2 tag
    size_t tag = ((size_t)(d[6] & 0x7F) << 21) | ((size_t)(d[7] & 0x7F) << 14)
               | ((size_t)(d[8] & 0x7F) << 7) | (size_t)(d[9] & 0x7F);
    pos = 10 + tag;
  }
  if (pos + 4 > n || memcmp(d + pos, "fLaC", 4) != 0) return false;
  pos += 4;
  bool have_si = false;
  for (;;) {
    if (pos + 4 > n) return false;
    int last = d[pos] >> 7;
    int type = d[pos] & 0x7F;
    size_t len = ((size_t)d[pos + 1] << 16) | ((size_t)d[pos + 2] << 8)
               | (size_t)d[pos + 3];
    pos += 4;
    if (pos + len > n) return false;
    if (type == 0) {  // STREAMINFO
      if (len < 34) return false;
      BitReader br{d + pos, len};
      si->min_block = (uint32_t)br.read_bits(16);
      si->max_block = (uint32_t)br.read_bits(16);
      br.read_bits(24);  // min frame size
      br.read_bits(24);  // max frame size
      si->sample_rate = (uint32_t)br.read_bits(20);
      si->channels = (int)br.read_bits(3) + 1;
      si->bits = (int)br.read_bits(5) + 1;
      si->total_samples = br.read_bits(36);
      have_si = true;
    }
    pos += len;
    if (last) break;
  }
  if (!have_si || si->sample_rate == 0) return false;
  si->first_frame = pos;
  return true;
}

bool read_utf8_number(BitReader* br, uint64_t* out) {
  uint32_t b = (uint32_t)br->read_bits(8);
  int cont;
  if ((b & 0x80) == 0) { *out = b; return !br->err; }
  else if ((b & 0xE0) == 0xC0) { cont = 1; *out = b & 0x1F; }
  else if ((b & 0xF0) == 0xE0) { cont = 2; *out = b & 0x0F; }
  else if ((b & 0xF8) == 0xF0) { cont = 3; *out = b & 0x07; }
  else if ((b & 0xFC) == 0xF8) { cont = 4; *out = b & 0x03; }
  else if ((b & 0xFE) == 0xFC) { cont = 5; *out = b & 0x01; }
  else if (b == 0xFE) { cont = 6; *out = 0; }
  else return false;
  for (int i = 0; i < cont; ++i) {
    uint32_t c = (uint32_t)br->read_bits(8);
    if ((c & 0xC0) != 0x80) return false;
    *out = (*out << 6) | (c & 0x3F);
  }
  return !br->err;
}

// Decode one residual-coded section into x[order..blocksize).
bool decode_residual(BitReader* br, int64_t* x, uint32_t blocksize,
                     int order) {
  int method = (int)br->read_bits(2);
  if (method > 1) return false;
  int plen = method == 0 ? 4 : 5;
  uint32_t escape = method == 0 ? 0xF : 0x1F;
  int po = (int)br->read_bits(4);
  uint32_t parts = 1u << po;
  if (blocksize % parts != 0) return false;
  uint32_t psize = blocksize >> po;
  if (psize < (uint32_t)order) return false;  // first partition would underflow
  uint32_t idx = order;
  for (uint32_t p = 0; p < parts; ++p) {
    uint32_t cnt = (p == 0) ? psize - order : psize;
    uint32_t param = (uint32_t)br->read_bits(plen);
    if (param == escape) {
      int raw = (int)br->read_bits(5);
      for (uint32_t i = 0; i < cnt; ++i) x[idx++] = br->read_signed(raw);
    } else {
      for (uint32_t i = 0; i < cnt; ++i) {
        uint32_t q = br->read_unary();
        uint64_t u = ((uint64_t)q << param) | br->read_bits((int)param);
        x[idx++] = (int64_t)(u >> 1) ^ -(int64_t)(u & 1);  // zigzag
      }
    }
    if (br->err) return false;
  }
  return idx == blocksize;
}

bool decode_subframe(BitReader* br, int64_t* x, uint32_t blocksize, int bps) {
  if (br->read_bits(1) != 0) return false;  // mandatory zero pad bit
  int type = (int)br->read_bits(6);
  int wasted = 0;
  if (br->read_bits(1)) wasted = (int)br->read_unary() + 1;
  bps -= wasted;
  if (br->err || bps <= 0 || bps > 33) return false;

  if (type == 0) {  // CONSTANT
    int64_t v = br->read_signed(bps);
    for (uint32_t i = 0; i < blocksize; ++i) x[i] = v;
  } else if (type == 1) {  // VERBATIM
    for (uint32_t i = 0; i < blocksize; ++i) x[i] = br->read_signed(bps);
  } else if ((type & 0x38) == 0x08 && (type & 0x07) <= 4) {  // FIXED 0-4
    int order = type & 0x07;
    if ((uint32_t)order > blocksize) return false;
    for (int i = 0; i < order; ++i) x[i] = br->read_signed(bps);
    if (!decode_residual(br, x, blocksize, order)) return false;
    switch (order) {
      case 0: break;
      case 1:
        for (uint32_t i = 1; i < blocksize; ++i) x[i] += x[i - 1];
        break;
      case 2:
        for (uint32_t i = 2; i < blocksize; ++i)
          x[i] += 2 * x[i - 1] - x[i - 2];
        break;
      case 3:
        for (uint32_t i = 3; i < blocksize; ++i)
          x[i] += 3 * x[i - 1] - 3 * x[i - 2] + x[i - 3];
        break;
      case 4:
        for (uint32_t i = 4; i < blocksize; ++i)
          x[i] += 4 * x[i - 1] - 6 * x[i - 2] + 4 * x[i - 3] - x[i - 4];
        break;
    }
  } else if (type & 0x20) {  // LPC, order 1-32
    int order = (type & 0x1F) + 1;
    if ((uint32_t)order > blocksize) return false;
    for (int i = 0; i < order; ++i) x[i] = br->read_signed(bps);
    int prec = (int)br->read_bits(4) + 1;
    if (prec == 16) return false;  // 0b1111 is invalid
    int shift = (int)br->read_signed(5);
    if (shift < 0) return false;
    int64_t coef[32];
    for (int i = 0; i < order; ++i) coef[i] = br->read_signed(prec);
    if (!decode_residual(br, x, blocksize, order)) return false;
    for (uint32_t i = order; i < blocksize; ++i) {
      int64_t acc = 0;
      for (int j = 0; j < order; ++j) acc += coef[j] * x[i - 1 - j];
      x[i] += acc >> shift;
    }
  } else {
    return false;  // reserved type
  }
  if (wasted)
    for (uint32_t i = 0; i < blocksize; ++i)
      x[i] = (int64_t)((uint64_t)x[i] << wasted);
  return !br->err;
}

struct FrameOut {
  uint32_t blocksize = 0;
  uint64_t sample_start = 0;  // absolute index of first sample
  int channels = 0;
  int bps = 0;
};

// Decode one frame at br's (byte-aligned) position. chan[c] must hold
// >= 65536 samples. Returns false on any bitstream error.
bool decode_frame(BitReader* br, const StreamInfo& si, int64_t** chan,
                  FrameOut* out) {
  size_t hdr_start = br->pos;
  if (br->read_bits(14) != 0x3FFE) return false;
  br->read_bits(1);  // reserved
  int variable = (int)br->read_bits(1);
  int bs_code = (int)br->read_bits(4);
  int sr_code = (int)br->read_bits(4);
  int ch_code = (int)br->read_bits(4);
  int ss_code = (int)br->read_bits(3);
  br->read_bits(1);  // reserved
  uint64_t num = 0;
  if (!read_utf8_number(br, &num)) return false;

  uint32_t blocksize;
  if (bs_code == 0) return false;
  else if (bs_code == 1) blocksize = 192;
  else if (bs_code <= 5) blocksize = 576u << (bs_code - 2);
  else if (bs_code == 6) blocksize = (uint32_t)br->read_bits(8) + 1;
  else if (bs_code == 7) blocksize = (uint32_t)br->read_bits(16) + 1;
  else blocksize = 256u << (bs_code - 8);

  if (sr_code == 12) br->read_bits(8);
  else if (sr_code == 13 || sr_code == 14) br->read_bits(16);
  else if (sr_code == 15) return false;

  int bps;
  switch (ss_code) {
    case 0: bps = si.bits; break;
    case 1: bps = 8; break;
    case 2: bps = 12; break;
    case 4: bps = 16; break;
    case 5: bps = 20; break;
    case 6: bps = 24; break;
    case 7: bps = 32; break;
    default: return false;
  }

  // header CRC-8 covers sync through the last header byte before the crc
  uint8_t expect = (uint8_t)br->read_bits(8);
  if (br->err) return false;
  if (crc8(br->d + hdr_start, br->pos - 1 - hdr_start) != expect) return false;

  int channels;
  int mode = 0;  // 0 independent, 1 left/side, 2 right/side, 3 mid/side
  if (ch_code < 8) channels = ch_code + 1;
  else if (ch_code == 8) { channels = 2; mode = 1; }
  else if (ch_code == 9) { channels = 2; mode = 2; }
  else if (ch_code == 10) { channels = 2; mode = 3; }
  else return false;
  if (channels != si.channels || blocksize > 65536) return false;

  for (int c = 0; c < channels; ++c) {
    int cbps = bps;
    // the side channel carries one extra bit
    if ((mode == 1 && c == 1) || (mode == 2 && c == 0) ||
        (mode == 3 && c == 1))
      cbps += 1;
    if (!decode_subframe(br, chan[c], blocksize, cbps)) return false;
  }
  br->align();
  uint16_t expect16 = (uint16_t)br->read_bits(16);
  if (br->err) return false;
  // frame CRC-16 covers everything from the sync code through the padding
  if (crc16(br->d + hdr_start, br->pos - 2 - hdr_start) != expect16)
    return false;

  if (mode == 1) {  // left/side: right = left - side
    for (uint32_t i = 0; i < blocksize; ++i)
      chan[1][i] = chan[0][i] - chan[1][i];
  } else if (mode == 2) {  // right/side: left = right + side
    for (uint32_t i = 0; i < blocksize; ++i) {
      int64_t side = chan[0][i];
      chan[0][i] = chan[1][i] + side;
    }
  } else if (mode == 3) {  // mid/side
    for (uint32_t i = 0; i < blocksize; ++i) {
      int64_t mid = chan[0][i];
      int64_t side = chan[1][i];
      mid = (mid << 1) | (side & 1);
      chan[0][i] = (mid + side) >> 1;
      chan[1][i] = (mid - side) >> 1;
    }
  }

  out->blocksize = blocksize;
  out->channels = channels;
  out->bps = bps;
  out->sample_start = variable ? num : num * si.min_block;
  return true;
}

uint8_t* read_file(const char* path, size_t* out_len) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long len = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (len <= 0) { fclose(f); return nullptr; }
  uint8_t* buf = (uint8_t*)malloc((size_t)len);
  if (!buf) { fclose(f); return nullptr; }
  size_t got = fread(buf, 1, (size_t)len, f);
  fclose(f);
  if (got != (size_t)len) { free(buf); return nullptr; }
  *out_len = (size_t)len;
  return buf;
}

}  // namespace

extern "C" {

// -> 0 on success. If STREAMINFO reports unknown length, decodes to count.
int aio_flac_info(const char* path, long* frames, int* sample_rate,
                  int* channels) {
  size_t len = 0;
  uint8_t* buf = read_file(path, &len);
  if (!buf) return -1;
  StreamInfo si;
  if (!parse_streaminfo(buf, len, &si)) { free(buf); return -2; }
  *sample_rate = (int)si.sample_rate;
  *channels = si.channels;
  if (si.total_samples != 0) {
    *frames = (long)si.total_samples;
    free(buf);
    return 0;
  }
  // unknown stream length: decode frames, counting
  BitReader br{buf, len};
  br.pos = si.first_frame;
  int64_t* chan[8];
  for (int c = 0; c < si.channels; ++c)
    chan[c] = (int64_t*)malloc(65536 * sizeof(int64_t));
  long total = 0;
  FrameOut fo;
  while (br.pos < br.n && decode_frame(&br, si, chan, &fo))
    total += fo.blocksize;
  for (int c = 0; c < si.channels; ++c) free(chan[c]);
  free(buf);
  *frames = total;
  return 0;
}

// Decode `frames` frames starting at `start` into out (mono float32).
// Returns frames written, or <0 on error. Decodes sequentially from the
// first frame (FLAC has no intrinsic random access without a seektable);
// the Python layer caches whole decoded files for repeated segment draws.
long aio_flac_read_segment(const char* path, long start, long frames,
                           float* out) {
  size_t len = 0;
  uint8_t* buf = read_file(path, &len);
  if (!buf) return -1;
  StreamInfo si;
  if (!parse_streaminfo(buf, len, &si)) { free(buf); return -2; }
  if (start < 0) start = 0;

  BitReader br{buf, len};
  br.pos = si.first_frame;
  int64_t* chan[8];
  for (int c = 0; c < si.channels; ++c)
    chan[c] = (int64_t*)malloc(65536 * sizeof(int64_t));

  long done = 0;       // samples written to out
  int64_t cursor = 0;  // absolute sample index of next frame's first sample
  FrameOut fo;
  bool bad = false;
  while (br.pos < br.n && done < frames) {
    if (!decode_frame(&br, si, chan, &fo)) {
      // failing before the declared stream length is a decode error;
      // trailing garbage after a fully-decoded stream is tolerated
      bad = si.total_samples == 0
                ? (done == 0 && cursor == 0)
                : (uint64_t)cursor < si.total_samples;
      break;
    }
    int64_t f0 = cursor;  // trust sequential order over header numbering
    cursor += fo.blocksize;
    if (cursor <= start) continue;
    float scale = 1.0f / (float)(1ull << (fo.bps - 1));
    float inv_ch = 1.0f / (float)fo.channels;
    int64_t lo = start > f0 ? start - f0 : 0;
    int64_t hi = fo.blocksize;
    if (f0 + hi > start + frames) hi = start + frames - f0;
    for (int64_t i = lo; i < hi; ++i) {
      float acc = 0.0f;
      for (int c = 0; c < fo.channels; ++c) acc += (float)chan[c][i];
      out[done++] = acc * inv_ch * scale;
    }
  }
  for (int c = 0; c < si.channels; ++c) free(chan[c]);
  free(buf);
  return bad ? -3 : done;
}

}  // extern "C"
