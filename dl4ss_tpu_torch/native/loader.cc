// Native host-side audio loader for dl4ss_tpu_torch (the port's own copy of
// dl4ss_tpu/native/loader.cc).
//
// The reference's host pipeline leans on two native libraries through Python
// wrappers: libsndfile (via soundfile, Torch_multi/predata_multiAims.py:138)
// and resampy's compiled polyphase resampler (:141-143). This file is the
// framework's own native equivalent: WAV decode (PCM 8/16/24/32 + float32),
// Kaiser-windowed polyphase resampling (scipy/resampy-compatible layout),
// fixed-length crop/pad, and a multithreaded batch loader that fills a
// caller-provided float32 bank ready for the device upload.
//
// Exposed as a plain C ABI consumed via ctypes
// (dl4ss_tpu_torch/native/__init__.py, which builds it at first use with
// g++ -O3 -shared -fPIC -std=c++17 ... -lpthread into dl4ss_tpu_torch/_build/).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;

// ---------------------------------------------------------------------------
// WAV decode
// ---------------------------------------------------------------------------

struct WavData {
  std::vector<float> samples;  // mono-ized
  int rate = 0;
};

uint32_t rd_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
uint16_t rd_u16(const uint8_t* p) {
  return (uint16_t)p[0] | ((uint16_t)p[1] << 8);
}

bool decode_wav_buffer(const uint8_t* data, size_t len, WavData* out) {
  if (len < 12 || memcmp(data, "RIFF", 4) || memcmp(data + 8, "WAVE", 4))
    return false;
  size_t pos = 12;
  int fmt = 0, channels = 0, bits = 0;
  const uint8_t* raw = nullptr;
  size_t raw_len = 0;
  while (pos + 8 <= len) {
    const uint8_t* cid = data + pos;
    uint32_t size = rd_u32(data + pos + 4);
    const uint8_t* body = data + pos + 8;
    if (pos + 8 + size > len) size = (uint32_t)(len - pos - 8);
    if (!memcmp(cid, "fmt ", 4) && size >= 16) {
      fmt = rd_u16(body);
      channels = rd_u16(body + 2);
      out->rate = (int)rd_u32(body + 4);
      bits = rd_u16(body + 14);
      if (fmt == 0xFFFE) fmt = 1;  // extensible -> treat as PCM
    } else if (!memcmp(cid, "data", 4)) {
      raw = body;
      raw_len = size;
    }
    pos += 8 + size + (size & 1);
  }
  if (!raw || channels <= 0) return false;
  size_t frame_bytes = (size_t)channels * (bits / 8);
  if (frame_bytes == 0) return false;
  size_t frames = raw_len / frame_bytes;
  out->samples.resize(frames);
  const double inv_ch = 1.0 / channels;
  for (size_t f = 0; f < frames; ++f) {
    double acc = 0.0;
    for (int c = 0; c < channels; ++c) {
      const uint8_t* p = raw + f * frame_bytes + (size_t)c * (bits / 8);
      double v = 0.0;
      if (fmt == 1) {  // PCM
        if (bits == 16) {
          v = (int16_t)rd_u16(p) / 32768.0;
        } else if (bits == 32) {
          v = (int32_t)rd_u32(p) / 2147483648.0;
        } else if (bits == 24) {
          int32_t s = (int32_t)((uint32_t)p[0] | ((uint32_t)p[1] << 8) |
                                ((uint32_t)p[2] << 16));
          s = (s << 8) >> 8;  // sign-extend
          v = s / 8388608.0;
        } else if (bits == 8) {
          v = ((int)p[0] - 128) / 128.0;
        } else {
          return false;
        }
      } else if (fmt == 3 && bits == 32) {  // IEEE float
        float fv;
        memcpy(&fv, p, 4);
        v = fv;
      } else {
        return false;
      }
      acc += v;
    }
    out->samples[f] = (float)(acc * inv_ch);
  }
  return true;
}

bool decode_wav_file(const char* path, WavData* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf((size_t)size);
  size_t got = fread(buf.data(), 1, (size_t)size, f);
  fclose(f);
  if (got != (size_t)size) return false;
  return decode_wav_buffer(buf.data(), buf.size(), out);
}

// ---------------------------------------------------------------------------
// Kaiser polyphase resampler (scipy.signal.resample_poly layout)
// ---------------------------------------------------------------------------

double bessel_i0(double x) {
  // series expansion; converges fast for the beta range used here
  double sum = 1.0, term = 1.0;
  const double y = x * x / 4.0;
  for (int k = 1; k < 64; ++k) {
    term *= y / (double)(k * k);
    sum += term;
    if (term < 1e-18 * sum) break;
  }
  return sum;
}

std::vector<double> design_kaiser_lowpass(int up, int down, double beta) {
  // matches scipy.resample_poly: half_len = 10*max_rate, cutoff 1/max_rate,
  // firwin(2*half_len+1, f_c, window=kaiser(beta), scale=True), then *up.
  int max_rate = up > down ? up : down;
  int half = 10 * max_rate;
  int taps = 2 * half + 1;
  double fc = 1.0 / max_rate;  // normalized to Nyquist
  std::vector<double> h(taps);
  const double denom = bessel_i0(beta);
  double sum = 0.0;
  for (int n = 0; n < taps; ++n) {
    double m = n - half;
    double sinc = (m == 0) ? fc : sin(kPi * fc * m) / (kPi * m);
    double r = 2.0 * n / (taps - 1) - 1.0;
    double w = bessel_i0(beta * sqrt(1.0 - r * r > 0 ? 1.0 - r * r : 0.0)) / denom;
    h[n] = sinc * w;
    sum += h[n];
  }
  for (auto& v : h) v = v / sum * up;  // DC gain 1 after upsampling
  return h;
}

void resample_poly(const float* x, int n_in, int up, int down,
                   double beta, std::vector<float>* out) {
  if (up == down) {
    out->assign(x, x + n_in);
    return;
  }
  std::vector<double> h = design_kaiser_lowpass(up, down, beta);
  int taps = (int)h.size();
  int delay = (taps - 1) / 2;
  int64_t n_out = ((int64_t)n_in * up + down - 1) / down;
  out->assign((size_t)n_out, 0.0f);
  for (int64_t m = 0; m < n_out; ++m) {
    // y[m] = sum_j h[j] * x_up[m*down + delay - j], x_up nonzero at mult. of up
    int64_t center = m * down + delay;
    // j = center - i*up for valid input index i
    int64_t i_min = (center - (taps - 1) + up - 1) / up;  // ceil
    if (i_min < 0) i_min = 0;
    int64_t i_max = center / up;
    if (i_max >= n_in) i_max = n_in - 1;
    double acc = 0.0;
    for (int64_t i = i_min; i <= i_max; ++i) {
      int64_t j = center - i * up;
      acc += h[(size_t)j] * x[(size_t)i];
    }
    (*out)[(size_t)m] = (float)acc;
  }
}

// crop/pad to fixed length (predata semantics: crop MAX_LEN, zero-pad tail)
void fit_length(const std::vector<float>& in, float* out, int n_fixed) {
  int n = (int)in.size();
  int c = n < n_fixed ? n : n_fixed;
  memcpy(out, in.data(), sizeof(float) * (size_t)c);
  if (c < n_fixed) memset(out + c, 0, sizeof(float) * (size_t)(n_fixed - c));
}

int load_one(const char* path, int target_rate, int max_len, float* out,
             double beta, int normalize) {
  WavData wav;
  if (!decode_wav_file(path, &wav)) return -1;
  std::vector<float> res;
  if (wav.rate != target_rate) {
    int g = 1;
    { int a = wav.rate, b = target_rate;
      while (b) { int t = a % b; a = b; b = t; } g = a; }
    resample_poly(wav.samples.data(), (int)wav.samples.size(),
                  target_rate / g, wav.rate / g, beta, &res);
  } else {
    res = std::move(wav.samples);
  }
  if (normalize) {
    // crop FIRST (reference order: crop -> mean-sub -> peak-norm -> pad,
    // predata_multiAims.py:144-159)
    if ((int)res.size() > max_len) res.resize((size_t)max_len);
    double mean = 0.0;
    for (float v : res) mean += v;
    mean /= res.empty() ? 1.0 : (double)res.size();
    double peak = 0.0;
    for (auto& v : res) { v = (float)(v - mean); double a = fabs(v); if (a > peak) peak = a; }
    if (peak > 1e-8) for (auto& v : res) v = (float)(v / peak);
  }
  fit_length(res, out, max_len);
  return (int)(res.size() < (size_t)max_len ? res.size() : (size_t)max_len);
}

}  // namespace

extern "C" {

// Decode a wav file; writes up to max_samples mono floats. Returns the
// number of samples available (may exceed max_samples), or -1 on error.
int dl4ss_decode_wav(const char* path, float* out, int max_samples,
                     int* rate_out) {
  WavData wav;
  if (!decode_wav_file(path, &wav)) return -1;
  *rate_out = wav.rate;
  int n = (int)wav.samples.size();
  int c = n < max_samples ? n : max_samples;
  memcpy(out, wav.samples.data(), sizeof(float) * (size_t)c);
  return n;
}

// Polyphase Kaiser resample. Returns output length, or -1 if out_cap small.
int dl4ss_resample_poly(const float* in, int n_in, int up, int down,
                        double beta, float* out, int out_cap) {
  std::vector<float> res;
  resample_poly(in, n_in, up, down, beta, &res);
  if ((int)res.size() > out_cap) return -1;
  memcpy(out, res.data(), sizeof(float) * res.size());
  return (int)res.size();
}

// Load one utterance: decode + resample to target_rate + (optional reference
// normalization) + crop/pad to max_len. Returns true sample count or -1.
int dl4ss_load_utterance(const char* path, int target_rate, int max_len,
                         int normalize, float* out) {
  return load_one(path, target_rate, max_len, out, 14.769656459379492,
                  normalize);
}

// Batch load with a thread pool: paths is a NULL-separated concatenation of
// n paths; out is (n, max_len) row-major. Returns number of failures.
int dl4ss_load_batch(const char* paths_blob, int n, int target_rate,
                     int max_len, int normalize, int num_threads,
                     float* out) {
  std::vector<const char*> paths;
  paths.reserve((size_t)n);
  const char* p = paths_blob;
  for (int i = 0; i < n; ++i) {
    paths.push_back(p);
    p += strlen(p) + 1;
  }
  if (num_threads < 1) num_threads = 1;
  std::vector<int> fails((size_t)num_threads, 0);
  std::vector<std::thread> pool;
  for (int t = 0; t < num_threads; ++t) {
    pool.emplace_back([&, t]() {
      for (int i = t; i < n; i += num_threads) {
        if (load_one(paths[(size_t)i], target_rate, max_len,
                     out + (size_t)i * max_len, 14.769656459379492,
                     normalize) < 0)
          fails[(size_t)t]++;
      }
    });
  }
  for (auto& th : pool) th.join();
  int total = 0;
  for (int f : fails) total += f;
  return total;
}

}  // extern "C"
