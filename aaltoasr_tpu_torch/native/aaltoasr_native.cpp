// Native host runtime for aaltoasr_tpu_torch: LNA codec + audio decode.
// A copy of aaltoasr_tpu/native/aaltoasr_native.cpp.
//
// The reference implements its whole runtime in C++; here the GPU does the
// math and the native layer owns the byte-level host paths that feed it:
// LNA quantization/dequantization (aku/PhoneProbsToolbox.cc:106-124 and
// decoder/src/LnaReaderCircular.cc:170-196 semantics, bit-exact) and RIFF
// WAV decoding to the int16-valued float samples the frontend consumes
// (aku/AudioReader.cc sf_read_short semantics).  Exposed as a C ABI for
// ctypes; Python falls back to NumPy when the library is not built.
//
// Build: g++ -O3 -shared -fPIC -o libaaltoasr_native_<hash>.so
//        aaltoasr_native.cpp   (native/__init__.py does this on first use,
//        into build/native/ at the repository root)

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>

extern "C" {

// 2-byte LNA encode: v = int(-1820*lp + 0.5), floor -36.008 -> 0xFFFF,
// big-endian output.
void lna_encode_u16(const float* log_probs, int64_t n, uint8_t* out) {
  for (int64_t i = 0; i < n; i++) {
    float lp = log_probs[i];
    uint32_t v;
    if (lp < -36.008f) {
      v = 0xFFFF;
    } else {
      int32_t t = (int32_t)(-1820.0 * (double)lp + 0.5);
      if (t < 0) t = 0;
      if (t > 0xFFFF) t = 0xFFFF;
      v = (uint32_t)t;
    }
    out[2 * i] = (uint8_t)((v >> 8) & 0xFF);
    out[2 * i + 1] = (uint8_t)(v & 0xFF);
  }
}

// 2-byte LNA decode: lp = (hi*256 + lo) / -1820.0
void lna_decode_u16(const uint8_t* data, int64_t n, float* out) {
  for (int64_t i = 0; i < n; i++) {
    uint32_t v = ((uint32_t)data[2 * i] << 8) | data[2 * i + 1];
    out[i] = (float)v / -1820.0f;
  }
}

// 1-byte LNA decode: lp = byte / -24.0
void lna_decode_u8(const uint8_t* data, int64_t n, float* out) {
  for (int64_t i = 0; i < n; i++) out[i] = (float)data[i] / -24.0f;
}

// Minimal RIFF/WAVE PCM16 decoder.  Returns sample count (mono-mixed),
// or -1 on parse error; *rate_out receives the sample rate.  out may be
// NULL to query the required size.
int64_t wav_read_pcm16(const char* path, float* out, int64_t max_samples,
                       int32_t* rate_out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  uint8_t hdr[12];
  if (fread(hdr, 1, 12, f) != 12 || memcmp(hdr, "RIFF", 4) ||
      memcmp(hdr + 8, "WAVE", 4)) {
    fclose(f);
    return -1;
  }
  uint16_t channels = 1, bits = 16;
  uint32_t rate = 16000;
  int64_t count = -1;
  for (;;) {
    uint8_t ch[8];
    if (fread(ch, 1, 8, f) != 8) break;
    uint32_t size = ch[4] | (ch[5] << 8) | (ch[6] << 16) |
                    ((uint32_t)ch[7] << 24);
    if (!memcmp(ch, "fmt ", 4)) {
      uint8_t fmt[16];
      if (size < 16 || fread(fmt, 1, 16, f) != 16) break;
      channels = fmt[2] | (fmt[3] << 8);
      rate = fmt[4] | (fmt[5] << 8) | (fmt[6] << 16) |
             ((uint32_t)fmt[7] << 24);
      bits = fmt[14] | (fmt[15] << 8);
      if (size > 16) fseek(f, size - 16, SEEK_CUR);
    } else if (!memcmp(ch, "data", 4)) {
      if (bits != 16 || channels < 1) break;
      int64_t frames = size / (2 * channels);
      count = frames;
      if (out) {
        if (frames > max_samples) frames = max_samples;
        int16_t buf[4096];
        int64_t done = 0;
        while (done < frames) {
          int64_t want = frames - done;
          int64_t chunk = 4096 / channels;
          if (want > chunk) want = chunk;
          size_t got = fread(buf, 2 * channels, want, f);
          if (got == 0) break;
          for (size_t i = 0; i < got; i++) {
            if (channels == 1) {
              out[done + i] = (float)buf[i];
            } else {
              int32_t acc = 0;
              for (int c = 0; c < channels; c++)
                acc += buf[i * channels + c];
              out[done + i] = (float)acc / channels;
            }
          }
          done += got;
        }
      }
      break;
    } else {
      fseek(f, size + (size & 1), SEEK_CUR);
    }
  }
  fclose(f);
  if (rate_out) *rate_out = (int32_t)rate;
  return count;
}

// Raw 16-bit little/big-endian file -> float samples.
int64_t raw_read_i16(const char* path, int32_t big_endian, float* out,
                     int64_t max_samples) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  int64_t n = ftell(f) / 2;
  fseek(f, 0, SEEK_SET);
  if (!out) {
    fclose(f);
    return n;
  }
  if (n > max_samples) n = max_samples;
  int16_t buf[8192];
  int64_t done = 0;
  while (done < n) {
    int64_t want = n - done;
    if (want > 8192) want = 8192;
    size_t got = fread(buf, 2, want, f);
    if (got == 0) break;
    for (size_t i = 0; i < got; i++) {
      int16_t v = buf[i];
      if (big_endian)
        v = (int16_t)(((uint16_t)v >> 8) | ((uint16_t)v << 8));
      out[done + i] = (float)v;
    }
    done += got;
  }
  fclose(f);
  return done;
}

}  // extern "C"
