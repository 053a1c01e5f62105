// Native host-side audio I/O and DSP for the data path (the port's own
// copy of the JAX repository's csrc/audio_io.cpp; the same code).
//
// WAV decode (PCM16/24/32/float32, mono mixdown), polyphase windowed-sinc
// resampling (the math of taste_spokenlm_tpu_torch.ops.audio.resample:
// hann-windowed sinc, lowpass_filter_width 6, rolloff 0.99), and
// multi-threaded batch resampling.
//
// Built at first use with g++ -O3 -shared into build/native/ and bound
// with ctypes (taste_spokenlm_tpu_torch/data/native.py).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;

int64_t gcd64(int64_t a, int64_t b) { return b ? gcd64(b, a % b) : a; }

struct Kernel {
  std::vector<float> taps;  // [new][width_taps]
  int64_t orig = 0, newr = 0;
  int64_t width = 0, taps_per_phase = 0;
};

// torchaudio-equivalent sinc resampling kernel (lowpass_filter_width=6,
// rolloff=0.99, hann window) — matches ops/audio._resample_kernel_np.
Kernel build_kernel(int64_t orig_freq, int64_t new_freq) {
  Kernel k;
  int64_t g = gcd64(orig_freq, new_freq);
  k.orig = orig_freq / g;
  k.newr = new_freq / g;
  const double lowpass_width = 6.0;
  const double rolloff = 0.99;
  const double base_freq = std::min(k.orig, k.newr) / 2.0 * rolloff;
  k.width = (int64_t)std::ceil(lowpass_width * k.orig / base_freq);
  k.taps_per_phase = 2 * k.width + k.orig;
  k.taps.resize(k.newr * k.taps_per_phase);
  const double scale = base_freq / k.orig;
  for (int64_t phase = 0; phase < k.newr; ++phase) {
    for (int64_t j = 0; j < k.taps_per_phase; ++j) {
      double idx = (double)(j - k.width) / k.orig;
      double t = ((double)-phase / k.newr + idx) * base_freq;
      if (t < -lowpass_width) t = -lowpass_width;
      if (t > lowpass_width) t = lowpass_width;
      double window = std::cos(t * kPi / lowpass_width / 2.0);
      window *= window;
      double sinc = (t == 0.0) ? 1.0 : std::sin(kPi * t) / (kPi * t);
      k.taps[phase * k.taps_per_phase + j] = (float)(sinc * window * scale);
    }
  }
  return k;
}

void resample_one(const Kernel& k, const float* in, int64_t n, float* out,
                  int64_t out_len) {
  // out[f * newr + phase] = sum_j taps[phase][j] * in_padded[f*orig + j]
  // with in_padded = [width zeros | in | width+orig zeros]
  for (int64_t o = 0; o < out_len; ++o) {
    int64_t f = o / k.newr;
    int64_t phase = o % k.newr;
    const float* taps = &k.taps[phase * k.taps_per_phase];
    double acc = 0.0;
    int64_t start = f * k.orig - k.width;
    for (int64_t j = 0; j < k.taps_per_phase; ++j) {
      int64_t src = start + j;
      if (src >= 0 && src < n) acc += (double)taps[j] * in[src];
    }
    out[o] = (float)acc;
  }
}

}  // namespace

extern "C" {

// Expected output length for resample(): ceil(new * n / orig).
int64_t resample_out_len(int64_t n, int64_t orig_freq, int64_t new_freq) {
  return (int64_t)((__int128)n * new_freq + orig_freq - 1) / orig_freq;
}

// Windowed-sinc polyphase resampling; out must hold resample_out_len floats.
void resample(const float* in, int64_t n, int64_t orig_freq, int64_t new_freq,
              float* out) {
  Kernel k = build_kernel(orig_freq, new_freq);
  resample_one(k, in, n, out, resample_out_len(n, orig_freq, new_freq));
}

// Batch resampling across threads: `count` signals with per-item lengths.
void resample_batch(const float* const* ins, const int64_t* lens,
                    int64_t count, int64_t orig_freq, int64_t new_freq,
                    float* const* outs, int num_threads) {
  Kernel k = build_kernel(orig_freq, new_freq);
  if (num_threads < 1) num_threads = 1;
  std::vector<std::thread> workers;
  for (int w = 0; w < num_threads; ++w) {
    workers.emplace_back([&, w]() {
      for (int64_t i = w; i < count; i += num_threads) {
        resample_one(k, ins[i], lens[i], outs[i],
                     resample_out_len(lens[i], orig_freq, new_freq));
      }
    });
  }
  for (auto& t : workers) t.join();
}

// Minimal RIFF/WAV reader: PCM16 / PCM24 / PCM32 / IEEE float32; mixes down
// to mono.  Returns 0 on success.  Pass out=nullptr to query n_samples.
int wav_read(const char* path, float* out, int64_t max_samples,
             int32_t* sample_rate, int64_t* n_samples) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  auto rd32 = [&](uint32_t* v) { return std::fread(v, 4, 1, f) == 1; };
  auto rd16 = [&](uint16_t* v) { return std::fread(v, 2, 1, f) == 1; };
  char tag[5] = {0};
  uint32_t riff_size = 0;
  if (std::fread(tag, 1, 4, f) != 4 || std::strncmp(tag, "RIFF", 4) ||
      !rd32(&riff_size) || std::fread(tag, 1, 4, f) != 4 ||
      std::strncmp(tag, "WAVE", 4)) {
    std::fclose(f);
    return -2;
  }
  uint16_t fmt = 0, channels = 0, bits = 0;
  uint32_t sr = 0;
  int64_t data_bytes = -1;
  long data_pos = -1;
  while (std::fread(tag, 1, 4, f) == 4) {
    uint32_t size = 0;
    if (!rd32(&size)) break;
    if (!std::strncmp(tag, "fmt ", 4)) {
      uint32_t byterate = 0;
      uint16_t blockalign = 0;
      rd16(&fmt);
      rd16(&channels);
      rd32(&sr);
      rd32(&byterate);
      rd16(&blockalign);
      rd16(&bits);
      std::fseek(f, size - 16, SEEK_CUR);
    } else if (!std::strncmp(tag, "data", 4)) {
      data_bytes = size;
      data_pos = std::ftell(f);
      std::fseek(f, size, SEEK_CUR);
    } else {
      std::fseek(f, size + (size & 1), SEEK_CUR);
    }
  }
  if (!channels || !sr || data_bytes < 0) {
    std::fclose(f);
    return -3;
  }
  int bytes_per = bits / 8;
  int64_t frames = data_bytes / (bytes_per * channels);
  *sample_rate = (int32_t)sr;
  *n_samples = frames;
  if (!out) {
    std::fclose(f);
    return 0;
  }
  frames = std::min<int64_t>(frames, max_samples);
  std::fseek(f, data_pos, SEEK_SET);
  std::vector<uint8_t> buf(bytes_per * channels);
  for (int64_t i = 0; i < frames; ++i) {
    if (std::fread(buf.data(), 1, buf.size(), f) != buf.size()) break;
    double acc = 0.0;
    for (int c = 0; c < channels; ++c) {
      const uint8_t* p = &buf[c * bytes_per];
      double v = 0.0;
      if (fmt == 3 && bits == 32) {
        float fv;
        std::memcpy(&fv, p, 4);
        v = fv;
      } else if (bits == 16) {
        int16_t s;
        std::memcpy(&s, p, 2);
        v = s / 32768.0;
      } else if (bits == 24) {
        int32_t s = (p[0] | (p[1] << 8) | (p[2] << 16));
        if (s & 0x800000) s |= ~0xFFFFFF;
        v = s / 8388608.0;
      } else if (bits == 32) {
        int32_t s;
        std::memcpy(&s, p, 4);
        v = s / 2147483648.0;
      }
      acc += v;
    }
    out[i] = (float)(acc / channels);
  }
  std::fclose(f);
  return 0;
}

}  // extern "C"
