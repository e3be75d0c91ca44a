// Chunked FFT resampler — C++ twin of streamz_tpu_torch/dsp/resample.py
// (the port's copy of native/resample.h).
//
// Same design as the Python spec (which mirrors rubato's FftFixedInOut
// sizing, streamz-rs/src/lib.rs:83-96): rational-ratio chunks
// Nin = k*fs_in/g (k = ceil(1024/(fs_in/g))), windowed-sinc anti-alias
// filter applied by fast convolution (zero-padded FFT, overlap-add).
// Double precision throughout so results match the numpy implementation to
// ~1e-9 and the i16 round trip truncates identically.
//
// FFT: iterative radix-2 for powers of two; Bluestein's algorithm for
// arbitrary lengths (needed because 2*Nin / 2*Nout are rarely powers of two).

#pragma once

#include <cmath>
#include <complex>
#include <cstdint>
#include <map>
#include <memory>
#include <mutex>
#include <numeric>
#include <vector>

namespace szr {

using cplx = std::complex<double>;

inline void fft_pow2(std::vector<cplx> &a, bool invert) {
  const size_t n = a.size();
  for (size_t i = 1, j = 0; i < n; i++) {
    size_t bit = n >> 1;
    for (; j & bit; bit >>= 1) j ^= bit;
    j ^= bit;
    if (i < j) std::swap(a[i], a[j]);
  }
  for (size_t len = 2; len <= n; len <<= 1) {
    double ang = 2.0 * M_PI / double(len) * (invert ? 1.0 : -1.0);
    cplx wl(std::cos(ang), std::sin(ang));
    for (size_t i = 0; i < n; i += len) {
      cplx w(1.0);
      for (size_t j = 0; j < len / 2; j++) {
        cplx u = a[i + j], v = a[i + j + len / 2] * w;
        a[i + j] = u + v;
        a[i + j + len / 2] = u - v;
        w *= wl;
      }
    }
  }
  if (invert) {
    for (auto &x : a) x /= double(n);
  }
}

inline size_t next_pow2(size_t n) {
  size_t p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Arbitrary-length DFT via Bluestein's chirp-z transform.
class Bluestein {
 public:
  explicit Bluestein(size_t n) : n_(n), m_(next_pow2(2 * n - 1)) {
    chirp_.resize(n_);
    for (size_t i = 0; i < n_; i++) {
      double ang = M_PI * double((unsigned long long)i * i % (2 * n_)) / double(n_);
      chirp_[i] = cplx(std::cos(ang), -std::sin(ang));
    }
    b_fft_.assign(m_, cplx(0.0));
    b_fft_[0] = std::conj(chirp_[0]);
    for (size_t i = 1; i < n_; i++) {
      b_fft_[i] = b_fft_[m_ - i] = std::conj(chirp_[i]);
    }
    fft_pow2(b_fft_, false);
  }

  // forward DFT (unnormalized); invert=true gives the inverse *without* 1/n.
  void transform(std::vector<cplx> &a, bool invert) const {
    std::vector<cplx> x(m_, cplx(0.0));
    for (size_t i = 0; i < n_; i++) {
      cplx c = invert ? std::conj(chirp_[i]) : chirp_[i];
      x[i] = a[i] * c;
    }
    fft_pow2(x, false);
    if (invert) {
      // convolution with conj(b): reuse b_fft via conjugation trick
      for (size_t i = 0; i < m_; i++) x[i] *= std::conj(b_fft_[i]);
    } else {
      for (size_t i = 0; i < m_; i++) x[i] *= b_fft_[i];
    }
    fft_pow2(x, true);
    for (size_t i = 0; i < n_; i++) {
      cplx c = invert ? std::conj(chirp_[i]) : chirp_[i];
      a[i] = x[i] * c;
    }
  }

 private:
  size_t n_, m_;
  std::vector<cplx> chirp_;
  std::vector<cplx> b_fft_;
};

// General FFT wrapper: radix-2 when possible, Bluestein otherwise.
class Fft {
 public:
  explicit Fft(size_t n) : n_(n) {
    if ((n & (n - 1)) != 0) blue_ = std::make_unique<Bluestein>(n);
  }
  void forward(std::vector<cplx> &a) const {
    if (blue_) blue_->transform(a, false);
    else fft_pow2(a, false);
  }
  void inverse(std::vector<cplx> &a) const {  // includes 1/n
    if (blue_) {
      blue_->transform(a, true);
      for (auto &x : a) x /= double(n_);
    } else {
      fft_pow2(a, true);
    }
  }

 private:
  size_t n_;
  std::unique_ptr<Bluestein> blue_;
};

struct Plan {
  size_t nin, nout;
  std::vector<cplx> filter_spec;  // rfft bins of the padded sinc, length nin+1
  std::shared_ptr<Fft> fft_in;    // length 2*nin
  std::shared_ptr<Fft> fft_out;   // length 2*nout
};

inline double blackman_harris(size_t i, size_t n) {
  double t = 2.0 * M_PI * double(i) / double(n > 1 ? n - 1 : 1);
  return 0.35875 - 0.48829 * std::cos(t) + 0.14128 * std::cos(2 * t) -
         0.01168 * std::cos(3 * t);
}

inline const Plan &get_plan(int fs_in, int fs_out) {
  static std::map<std::pair<int, int>, Plan> cache;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  auto key = std::make_pair(fs_in, fs_out);
  auto it = cache.find(key);
  if (it != cache.end()) return it->second;

  int g = std::gcd(fs_in, fs_out);
  size_t nin_unit = size_t(fs_in / g), nout_unit = size_t(fs_out / g);
  size_t k = (1024 + nin_unit - 1) / nin_unit;
  if (k < 1) k = 1;
  size_t nin = k * nin_unit, nout = k * nout_unit;

  // Windowed sinc, cutoff relaxed like the Python spec.
  double relax = std::pow(0.4, 16.0 / double(nin));
  double cutoff = relax * std::min(1.0, double(nout) / double(nin));
  std::vector<double> sinc(nin);
  double sum = 0.0;
  for (size_t i = 0; i < nin; i++) {
    double t = double(i) - double(nin - 1) / 2.0;
    double x = cutoff * t;
    double s = (x == 0.0) ? 1.0 : std::sin(M_PI * x) / (M_PI * x);
    sinc[i] = cutoff * s * blackman_harris(i, nin);
    sum += sinc[i];
  }
  for (auto &v : sinc) v /= sum;

  Plan plan;
  plan.nin = nin;
  plan.nout = nout;
  plan.fft_in = std::make_shared<Fft>(2 * nin);
  plan.fft_out = std::make_shared<Fft>(2 * nout);

  std::vector<cplx> f(2 * nin, cplx(0.0));
  for (size_t i = 0; i < nin; i++) f[i] = sinc[i];
  plan.fft_in->forward(f);
  plan.filter_spec.assign(f.begin(), f.begin() + nin + 1);

  auto res = cache.emplace(key, std::move(plan));
  return res.first->second;
}

// Resample x (arbitrary length) from fs_in to fs_out. Output length is
// ceil'd to whole output chunks (caller truncates to n*fs_out/fs_in).
inline std::vector<double> resample(const std::vector<double> &x, int fs_in,
                                    int fs_out) {
  if (fs_in == fs_out) return x;
  const Plan &p = get_plan(fs_in, fs_out);
  size_t n_chunks = (x.size() + p.nin - 1) / p.nin;
  if (n_chunks == 0) n_chunks = 1;

  std::vector<double> out(n_chunks * p.nout, 0.0);
  std::vector<double> overlap(p.nout, 0.0);
  std::vector<cplx> buf;
  std::vector<cplx> obuf;
  size_t m = std::min(p.nin, p.nout);
  double scale = double(p.nout) / double(p.nin);

  for (size_t c = 0; c < n_chunks; c++) {
    buf.assign(2 * p.nin, cplx(0.0));
    for (size_t i = 0; i < p.nin; i++) {
      size_t idx = c * p.nin + i;
      if (idx < x.size()) buf[i] = x[idx];
    }
    p.fft_in->forward(buf);

    obuf.assign(2 * p.nout, cplx(0.0));
    for (size_t k2 = 0; k2 <= m; k2++) {
      cplx v = buf[k2] * p.filter_spec[k2];
      obuf[k2] = v;
      if (k2 != 0 && k2 != p.nout) obuf[2 * p.nout - k2] = std::conj(v);
    }
    p.fft_out->inverse(obuf);

    for (size_t i = 0; i < p.nout; i++) {
      out[c * p.nout + i] = obuf[i].real() * scale + overlap[i];
      overlap[i] = obuf[p.nout + i].real() * scale;
    }
  }
  return out;
}

// i16 round trip matching the reference (src/lib.rs:186-209): /32767 in,
// *32767 clamp trunc out; output length floor(n*fs_out/fs_in).
inline std::vector<int16_t> resample_i16(const int16_t *x, size_t n,
                                         int fs_in, int fs_out) {
  if (fs_in == fs_out) return std::vector<int16_t>(x, x + n);
  std::vector<double> xd(n);
  for (size_t i = 0; i < n; i++) xd[i] = double(x[i]) / 32767.0;
  std::vector<double> y = resample(xd, fs_in, fs_out);
  size_t n_out = n * size_t(fs_out) / size_t(fs_in);
  if (n_out > y.size()) n_out = y.size();
  std::vector<int16_t> out(n_out);
  for (size_t i = 0; i < n_out; i++) {
    double v = y[i] * 32767.0;
    if (v > 32767.0) v = 32767.0;
    if (v < -32768.0) v = -32768.0;
    out[i] = int16_t(std::trunc(v));
  }
  return out;
}

}  // namespace szr
