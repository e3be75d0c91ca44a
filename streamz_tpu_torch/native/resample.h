// Chunked FFT resampler — C++ twin of streamz_tpu_torch/dsp/resample.py
// (the port's copy of native/resample.h).
//
// Same design as the Python spec (which mirrors rubato's FftFixedInOut
// sizing, streamz-rs/src/lib.rs:83-96): rational-ratio chunks
// Nin = k*fs_in/g (k = ceil(1024/(fs_in/g))), windowed-sinc anti-alias
// filter applied by fast convolution (zero-padded FFT, overlap-add).
// Double precision throughout so results match the numpy implementation to
// ~1e-12 and the i16 round trip truncates identically.
//
// Transforms: each chunk's real forward FFT of length 2*Nin and real inverse
// of length 2*Nout run as complex FFTs of the half lengths Nin and Nout, the
// even samples as real parts and the odd ones as imaginary parts, with the
// split post-twiddle (forward) and pre-twiddle (inverse) of real data.  A
// complex FFT is planned once per length (`Fft`): Stockham autosort passes
// over the radices 4 and 2 and every odd prime factor up to kMaxRadix (31),
// with every twiddle and butterfly constant precomputed.  A length with a
// larger prime factor (the 211 of 44099 Hz -> 44.1 kHz) runs Bluestein's
// chirp-z transform over a power-of-two plan instead.  The plans of a rate
// pair are built once, cached and shared read-only; each caller (one per
// pool thread) brings its own `Scratch`, reused across chunks and clips, so
// no chunk allocates.

#pragma once

#include <algorithm>
#include <cmath>
#include <complex>
#include <cstdint>
#include <map>
#include <memory>
#include <mutex>
#include <numeric>
#include <vector>

namespace szr {
// Internal linkage throughout: the JAX package's library defines a resampler
// under the same names, a process may load both, and a function-local static
// of an inline function (get_plan's cache) would be one object for the whole
// process (STB_GNU_UNIQUE), whatever the library.
namespace {

using cplx = std::complex<double>;

// Products written out: std::complex's operator* checks for NaN on every call.
inline cplx cmul(cplx a, cplx b) {
  return cplx(a.real() * b.real() - a.imag() * b.imag(),
              a.real() * b.imag() + a.imag() * b.real());
}

// exp(-2*pi*i * k/n), the angle reduced exactly before the sine and cosine.
inline cplx unit_root(size_t k, size_t n) {
  double ang = -2.0 * M_PI * double(k % n) / double(n);
  return cplx(std::cos(ang), std::sin(ang));
}

constexpr size_t kMaxRadix = 31;  // larger prime factors take Bluestein

// Unnormalised forward DFT, X[k] = sum_j x[j] exp(-2*pi*i*jk/n), of one
// length.  Inverse transforms conjugate on the way in and out.
class Fft {
 public:
  explicit Fft(size_t n) : n_(n) {
    std::vector<size_t> radices;
    size_t rest = n;
    while (rest % 4 == 0) radices.push_back(4), rest /= 4;
    if (rest % 2 == 0) radices.push_back(2), rest /= 2;
    for (size_t p = 3; p <= kMaxRadix; p += 2)
      while (rest % p == 0) radices.push_back(p), rest /= p;
    if (rest > 1) {
      plan_bluestein();
      return;
    }
    size_t ns = 1;
    for (size_t p : radices) {
      Pass ps{p, ns, tw_.size(), trig_.size()};
      // Twiddles exp(-2*pi*i * r*k/(ns*p)) for r in [1, p), k in [0, ns).
      for (size_t r = 1; r < p; r++)
        for (size_t k = 0; k < ns; k++) tw_.push_back(unit_root(r * k, ns * p));
      if (p % 2 == 1)
        for (size_t j = 0; j < p; j++) trig_.push_back(unit_root(j, p));
      passes_.push_back(ps);
      ns *= p;
    }
  }

  size_t size() const { return n_; }
  // Complex values of work space that forward() needs beside its input.
  size_t work_size() const { return inner_ ? 2 * inner_->size() : n_; }

  // Transforms a[0, n) with `work` (work_size() values) beside it; the
  // result lands in a or in work, whichever pointer is returned.
  cplx *forward(cplx *a, cplx *work) const {
    if (inner_) return bluestein(a, work);
    cplx *in = a, *out = work;
    for (const Pass &ps : passes_) {
      switch (ps.p) {
        case 2: run_pass<2>(ps, in, out); break;
        case 3: run_pass<3>(ps, in, out); break;
        case 4: run_pass<4>(ps, in, out); break;
        case 5: run_pass<5>(ps, in, out); break;
        case 7: run_pass<7>(ps, in, out); break;
        default: run_pass<0>(ps, in, out); break;
      }
      std::swap(in, out);
    }
    return in;
  }

 private:
  struct Pass {
    size_t p;     // radix
    size_t ns;    // product of the radices before this pass
    size_t tw;    // offset of this pass's twiddles in tw_
    size_t trig;  // offset of exp(-2*pi*i*j/p), j in [0, p), in trig_ (odd p)
  };

  // One Stockham pass: for q in [0, n/(p*ns)) and k in [0, ns), the p
  // inputs in[q*ns + k + r*n/p], twiddled by exp(-2*pi*i*rk/(ns*p)), go
  // through a p-point DFT into out[q*ns*p + k + r*ns].
  template <size_t P>
  void run_pass(const Pass &ps, const cplx *in, cplx *out) const {
    const size_t p = P ? P : ps.p, ns = ps.ns, stride = n_ / p, m = stride / ns;
    const cplx *tw = tw_.data() + ps.tw;
    const cplx *trig = trig_.data() + ps.trig;
    cplx v[kMaxRadix];
    for (size_t q = 0; q < m; q++) {
      const cplx *src = in + q * ns;
      cplx *dst = out + q * ns * p;
      for (size_t k = 0; k < ns; k++) {
        v[0] = src[k];
        if (ns == 1) {
          for (size_t r = 1; r < p; r++) v[r] = src[k + r * stride];
        } else {
          for (size_t r = 1; r < p; r++)
            v[r] = cmul(src[k + r * stride], tw[(r - 1) * ns + k]);
        }
        butterfly<P>(v, p, trig, dst + k, ns);
      }
    }
  }

  // p-point DFT of v, written to y[r*s].
  template <size_t P>
  static void butterfly(const cplx *v, size_t p_rt, const cplx *trig, cplx *y,
                        size_t s) {
    if (P == 2) {
      y[0] = v[0] + v[1];
      y[s] = v[0] - v[1];
    } else if (P == 4) {
      cplx t0 = v[0] + v[2], t1 = v[0] - v[2], t2 = v[1] + v[3];
      cplx d = v[1] - v[3];
      cplx t3(d.imag(), -d.real());  // -i * (v1 - v3)
      y[0] = t0 + t2;
      y[s] = t1 + t3;
      y[2 * s] = t0 - t2;
      y[3 * s] = t1 - t3;
    } else {
      // Odd p: pair j with p - j.  y[k] = v0 + sum_j cos(2*pi*jk/p) b_j
      // - i sin(2*pi*jk/p) d_j, and y[p-k] its mirror, where
      // b_j = v_j + v_{p-j} and d_j = v_j - v_{p-j}.
      const size_t p = P ? P : p_rt, h = (p - 1) / 2;
      cplx b[kMaxRadix / 2 + 1], d[kMaxRadix / 2 + 1];
      cplx y0 = v[0];
      for (size_t j = 1; j <= h; j++) {
        b[j] = v[j] + v[p - j];
        d[j] = v[j] - v[p - j];
        y0 += b[j];
      }
      y[0] = y0;
      for (size_t k = 1; k <= h; k++) {
        double tr = v[0].real(), ti = v[0].imag(), ur = 0.0, ui = 0.0;
        size_t idx = 0;
        for (size_t j = 1; j <= h; j++) {
          idx += k;
          if (idx >= p) idx -= p;
          const double c = trig[idx].real(), sn = -trig[idx].imag();
          tr += c * b[j].real();
          ti += c * b[j].imag();
          ur += sn * d[j].real();
          ui += sn * d[j].imag();
        }
        y[k * s] = cplx(tr + ui, ti - ur);
        y[(p - k) * s] = cplx(tr - ui, ti + ur);
      }
    }
  }

  // Bluestein: exp(-2*pi*i*jk/n) = c[j] c[k] conj(c[k-j]) with
  // c[j] = exp(-pi*i*j^2/n), so the DFT is a chirp, a circular convolution
  // of length m (a power of two >= 2n - 1) by FFTs, and a chirp.
  void plan_bluestein() {
    size_t m = 1;
    while (m < 2 * n_ - 1) m <<= 1;
    inner_ = std::make_unique<Fft>(m);
    chirp_.resize(n_);
    for (size_t i = 0; i < n_; i++) {
      // j^2 mod 2n keeps the angle exact for large j.
      chirp_[i] = unit_root((unsigned long long)i * i % (2 * n_), 2 * n_);
    }
    std::vector<cplx> b(m, cplx(0.0)), work(inner_->work_size());
    b[0] = std::conj(chirp_[0]);
    for (size_t i = 1; i < n_; i++) b[i] = b[m - i] = std::conj(chirp_[i]);
    cplx *spec = inner_->forward(b.data(), work.data());
    bspec_.assign(spec, spec + m);
  }

  cplx *bluestein(cplx *a, cplx *work) const {
    const size_t m = inner_->size();
    cplx *x = work, *w = work + m;
    for (size_t i = 0; i < n_; i++) x[i] = cmul(a[i], chirp_[i]);
    std::fill(x + n_, x + m, cplx(0.0));
    cplx *r = inner_->forward(x, w);
    // The inverse transform of the product, as conj(forward(conj(.))).
    for (size_t i = 0; i < m; i++) r[i] = std::conj(cmul(r[i], bspec_[i]));
    r = inner_->forward(r, r == x ? w : x);
    const double inv_m = 1.0 / double(m);
    for (size_t i = 0; i < n_; i++)
      a[i] = cmul(std::conj(r[i]), chirp_[i]) * inv_m;
    return a;
  }

  size_t n_;
  std::vector<Pass> passes_;
  std::vector<cplx> tw_;
  std::vector<cplx> trig_;
  std::unique_ptr<Fft> inner_;  // Bluestein's power-of-two transform
  std::vector<cplx> chirp_, bspec_;
};

// A caller's buffers, grown to the largest plan it meets and kept across
// chunks and clips.  One per thread: plans are shared, scratch is not.
struct Scratch {
  std::vector<cplx> a, work, spec;
  std::vector<double> overlap;

  void reserve(size_t na, size_t nwork, size_t nspec, size_t nover) {
    if (a.size() < na) a.resize(na);
    if (work.size() < nwork) work.resize(nwork);
    if (spec.size() < nspec) spec.resize(nspec);
    if (overlap.size() < nover) overlap.resize(nover);
  }
};

struct Plan {
  size_t nin, nout, m;                // m = min(nin, nout): bins kept
  std::unique_ptr<Fft> fft_in;        // complex length nin (real 2*nin)
  std::unique_ptr<Fft> fft_out;       // complex length nout (real 2*nout)
  std::vector<cplx> post_in;          // exp(-pi*i*k/nin), k in [0, m]
  std::vector<cplx> pre_out;          // exp(+pi*i*k/nout), k in [0, nout)
  std::vector<cplx> filter_spec;      // rfft bins of the padded sinc, [0, m]

  void reserve(Scratch &s) const {
    size_t na = std::max(nin, nout);
    s.reserve(na, std::max(fft_in->work_size(), fft_out->work_size()),
              nout + 1, nout);
  }

  // Bins [0, m] of the real FFT of length 2*nin of the signal whose
  // samples 2j and 2j+1 are the real and imaginary parts of z[j],
  // j in [0, nin): z = FFT_nin(z), then the split post-twiddle
  // X[k] = (Z[k] + conj Z[nin-k])/2 - i w^k (Z[k] - conj Z[nin-k])/2.
  // Returns a pointer to the bins, in s.spec.
  cplx *rfft(Scratch &s) const {
    const cplx *z = fft_in->forward(s.a.data(), s.work.data());
    cplx *x = s.spec.data();
    for (size_t k = 0; k <= m; k++) {
      cplx zk = z[k == nin ? 0 : k], zr = std::conj(z[k == 0 ? 0 : nin - k]);
      cplx e = zk + zr, wo = cmul(post_in[k], zk - zr);
      x[k] = cplx(0.5 * (e.real() + wo.imag()), 0.5 * (e.imag() - wo.real()));
    }
    return x;
  }

  // The unnormalised real inverse FFT of length 2*nout of the half
  // spectrum y[0, nout] (y[k] = 0 past m; the imaginary parts of y[0] and
  // y[nout] are dropped, as numpy's irfft drops them): the pre-twiddle
  // Z[k] = (y[k] + conj y[nout-k]) + i w^-k (y[k] - conj y[nout-k]), a
  // complex inverse FFT of length nout, samples 2j and 2j+1 in the real and
  // imaginary parts of its output j.  The inverse runs as
  // conj(forward(conj Z)): the returned values are conjugated.
  const cplx *irfft_conj(cplx *y, Scratch &s) const {
    y[0] = cplx(y[0].real(), 0.0);
    if (m == nout) y[nout] = cplx(y[nout].real(), 0.0);
    cplx *zc = s.a.data();
    for (size_t k = 0; k < nout; k++) {
      size_t r = nout - k;
      cplx yk = k <= m ? y[k] : cplx(0.0);
      cplx yr = r <= m ? std::conj(y[r]) : cplx(0.0);
      cplx e = yk + yr, wo = cmul(pre_out[k], yk - yr);
      // conj(e + i*wo)
      zc[k] = cplx(e.real() - wo.imag(), -(e.imag() + wo.real()));
    }
    return fft_out->forward(zc, s.work.data());
  }
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
  plan.m = std::min(nin, nout);
  plan.fft_in = std::make_unique<Fft>(nin);
  plan.fft_out = std::make_unique<Fft>(nout);
  plan.post_in.resize(plan.m + 1);
  for (size_t i = 0; i <= plan.m; i++) plan.post_in[i] = unit_root(i, 2 * nin);
  plan.pre_out.resize(nout);
  for (size_t i = 0; i < nout; i++)
    plan.pre_out[i] = std::conj(unit_root(i, 2 * nout));

  Scratch s;
  plan.reserve(s);
  for (size_t j = 0; j < nin; j++) {
    double re = 2 * j < nin ? sinc[2 * j] : 0.0;
    double im = 2 * j + 1 < nin ? sinc[2 * j + 1] : 0.0;
    s.a[j] = cplx(re, im);
  }
  const cplx *spec = plan.rfft(s);
  plan.filter_spec.assign(spec, spec + plan.m + 1);

  auto res = cache.emplace(key, std::move(plan));
  return res.first->second;
}

// Output length of the i16 round trip: floor(n*fs_out/fs_in).
inline size_t resampled_len(size_t n, int fs_in, int fs_out) {
  return n * size_t(fs_out) / size_t(fs_in);
}

// i16 round trip matching the reference (src/lib.rs:186-209): /32767 in,
// *32767 clamp trunc out; writes resampled_len(n, ...) samples to out.
// fs_in != fs_out.
inline void resample_i16(const int16_t *x, size_t n, int fs_in, int fs_out,
                         int16_t *out, Scratch &s) {
  const size_t n_out = resampled_len(n, fs_in, fs_out);
  if (n_out == 0) return;
  const Plan &p = get_plan(fs_in, fs_out);
  p.reserve(s);
  const size_t nin = p.nin, nout = p.nout;
  // irfft's 1/(2*nout) and the spec's nout/nin; odd samples come out of
  // the conjugated inverse negated.
  const double gain = 1.0 / double(2 * nout) * (double(nout) / double(nin));
  const double sign[2] = {gain, -gain};
  double *overlap = s.overlap.data();
  std::fill(overlap, overlap + nout, 0.0);

  for (size_t c = 0; c * nout < n_out; c++) {
    // The chunk's samples, zero-padded to 2*nin, as nin complex pairs.
    const size_t avail = c * nin < n ? std::min(nin, n - c * nin) : 0;
    const int16_t *xc = x + c * nin;
    cplx *z = s.a.data();
    size_t j = 0;
    for (; 2 * j + 1 < avail; j++)
      z[j] = cplx(double(xc[2 * j]) / 32767.0, double(xc[2 * j + 1]) / 32767.0);
    if (2 * j < avail) z[j] = cplx(double(xc[2 * j]) / 32767.0, 0.0), j++;
    std::fill(z + j, z + nin, cplx(0.0));

    cplx *y = p.rfft(s);
    for (size_t k = 0; k <= p.m; k++) y[k] = cmul(y[k], p.filter_spec[k]);
    const double *w = reinterpret_cast<const double *>(p.irfft_conj(y, s));

    // Overlap-add: sample t of the chunk's 2*nout is w[t] times sign[t&1];
    // the first nout plus the last chunk's tail go out (*32767, clamped,
    // truncated toward zero), the last nout wait for the next chunk.
    int16_t *o = out + c * nout;
    const size_t head = std::min(nout, n_out - c * nout);
    for (size_t t = 0; t < head; t++) {
      double q = (w[t] * sign[t & 1] + overlap[t]) * 32767.0;
      q = std::min(32767.0, std::max(-32768.0, q));
      o[t] = int16_t(q);
    }
    for (size_t t = nout; t < 2 * nout; t++) overlap[t - nout] = w[t] * sign[t & 1];
  }
}

}  // namespace
}  // namespace szr
