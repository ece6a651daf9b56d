// tortoise_tpu_torch native runtime: hot host-side ops for the serving path.
//
// The reference has no first-party native code (its native surface is
// third-party CUDA kernels); this framework's host-side hot loops live here:
//  * polyphase windowed-sinc resampling (22.05k<->24k<->16k conversions on
//    every request — the scipy path costs milliseconds per clip),
//  * the O(n*m) character-alignment DP used by redaction (pure-Python is
//    quadratic-slow for long texts),
//  * linear-crossfade chunk stitching for the streaming server.
//
// Exposed as a plain C ABI consumed via ctypes (tortoise_tpu_torch/native/__init__.py),
// which builds it at first use with
//   make -C tortoise_tpu_torch/native OUT=<build dir>/libaudioio.so
// into build/native/ beside the package, never into the package itself.
// A copy of tortoise_tpu/native/audioio.cpp: the port imports nothing of the
// JAX package.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// --------------------------------------------------------------------------
// Polyphase resampler: upfirdn with a Kaiser-windowed sinc prototype.
// Returns the number of output samples written (or required if out==nullptr).
// --------------------------------------------------------------------------

static double bessel_i0(double x) {
  // series expansion; converges fast for the beta range we use
  double sum = 1.0, term = 1.0;
  for (int k = 1; k < 64; ++k) {
    term *= (x / (2.0 * k)) * (x / (2.0 * k));
    sum += term;
    if (term < 1e-16 * sum) break;
  }
  return sum;
}

static int64_t gcd64(int64_t a, int64_t b) {
  while (b) { int64_t t = a % b; a = b; b = t; }
  return a;
}

int64_t resample_f32(const float* in, int64_t n_in, int64_t sr_in,
                     int64_t sr_out, float* out, int64_t max_out) {
  if (sr_in == sr_out) {
    if (out) std::memcpy(out, in, sizeof(float) * std::min(n_in, max_out));
    return n_in;
  }
  int64_t g = gcd64(sr_in, sr_out);
  int64_t up = sr_out / g, down = sr_in / g;
  int64_t n_out = (n_in * up + down - 1) / down;
  if (!out) return n_out;
  if (n_out > max_out) n_out = max_out;

  // Prototype lowpass at min(1/up, 1/down) of the upsampled Nyquist.
  const double beta = 8.555;           // ~80 dB stopband Kaiser
  const int half_len_base = 32;        // taps per phase (one side)
  int64_t max_rate = up > down ? up : down;
  int64_t half_len = half_len_base * max_rate;
  double cutoff = 1.0 / (double)max_rate;  // in units of upsampled Nyquist
  int64_t taps = 2 * half_len + 1;

  std::vector<double> h(taps);
  double i0b = bessel_i0(beta);
  for (int64_t i = 0; i < taps; ++i) {
    double m = (double)(i - half_len);
    double sinc = (m == 0.0) ? cutoff
                             : std::sin(M_PI * cutoff * m) / (M_PI * m);
    double r = m / (double)half_len;
    double w = bessel_i0(beta * std::sqrt(1.0 - r * r)) / i0b;
    h[i] = (double)up * sinc * w;
  }

  // upfirdn: y[j] = sum_k h[k] * x_up[j*down - half_len + k]
  // where x_up[i] = in[i/up] when i % up == 0 else 0.
  for (int64_t j = 0; j < n_out; ++j) {
    int64_t origin = j * down - half_len;
    double acc = 0.0;
    // only k where (origin + k) % up == 0 contribute
    int64_t rem = ((origin % up) + up) % up;
    int64_t k0 = (rem == 0) ? 0 : up - rem;
    for (int64_t k = k0; k < taps; k += up) {
      int64_t idx = (origin + k) / up;
      if (idx >= 0 && idx < n_in) acc += h[k] * (double)in[idx];
    }
    out[j] = (float)acc;
  }
  return n_out;
}

// --------------------------------------------------------------------------
// Character alignment DP (see utils/wav2vec_alignment.max_alignment).
// Writes the aligned string (s1 with '~' for unmatched chars) into out
// (caller allocates n1+1 bytes). Tie-breaking matches the reference:
// prefer consuming s2 when scores are equal.
// --------------------------------------------------------------------------

void align_dp(const char* s1, int64_t n1, const char* s2, int64_t n2,
              char* out, char skip) {
  if (n1 == 0) { out[0] = 0; return; }
  if (n2 == 0) {
    for (int64_t i = 0; i < n1; ++i) out[i] = skip;
    out[n1] = 0;
    return;
  }
  std::vector<int32_t> score((n1 + 1) * (n2 + 1), 0);
  auto S = [&](int64_t i, int64_t j) -> int32_t& {
    return score[i * (n2 + 1) + j];
  };
  for (int64_t i = n1 - 1; i >= 0; --i)
    for (int64_t j = n2 - 1; j >= 0; --j)
      S(i, j) = (s1[i] == s2[j]) ? 1 + S(i + 1, j + 1)
                                 : (S(i, j + 1) > S(i + 1, j) ? S(i, j + 1)
                                                              : S(i + 1, j));
  int64_t i = 0, j = 0, o = 0;
  while (i < n1) {
    if (j >= n2) { out[o++] = skip; ++i; }
    else if (s1[i] == s2[j]) { out[o++] = s1[i]; ++i; ++j; }
    else if (S(i, j + 1) > S(i + 1, j)) ++j;
    else { out[o++] = skip; ++i; }
  }
  out[o] = 0;
}

// --------------------------------------------------------------------------
// Streaming crossfade: blend the head of `chunk` with `overlap` in place.
// --------------------------------------------------------------------------

void crossfade_f32(float* chunk, const float* overlap, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    float t = (n == 1) ? 0.0f : (float)i / (float)(n - 1);
    chunk[i] = overlap[i] * (1.0f - t) + chunk[i] * t;
  }
}

}  // extern "C"
