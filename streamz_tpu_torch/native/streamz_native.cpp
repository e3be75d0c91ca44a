// StreamZ-TPU native host runtime: audio ingest in C++.
//
// The reference's native components are minimp3 (vendored C decoder behind
// minimp3-sys), hound's WAV codec, and a rayon thread pool fanning decode
// work across cores (streamz-rs/src/lib.rs:399-547, Cargo.lock).  This
// library is their host-side equivalent: libmpg123-backed MP3 decode
// (dlopen'd, no headers needed), a RIFF/WAVE 16-bit codec, and a
// std::thread pool batch decoder that feeds the device pipeline.
//
// The PyTorch/CUDA port's own copy of native/streamz_native.cpp, built by
// g++ at first use into streamz_tpu_torch/_build/ and consumed via ctypes
// (streamz_tpu_torch/io/native.py).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <dlfcn.h>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#include "resample.h"

extern "C" {

struct SzClip {
  int16_t *samples;  // malloc'd; caller frees via sz_free
  int64_t len;       // total interleaved samples
  int32_t rate;
  int32_t channels;
  int32_t status;  // 0 = ok, nonzero = error
};

// ---------------------------------------------------------------------------
// libmpg123 dynamic binding (API-stable since 1.x; decoded s16 like the
// reference's minimp3 path, first frame fixing rate/channels,
// src/lib.rs:416-444).
// ---------------------------------------------------------------------------

namespace {

typedef void *mpg123_handle_t;

struct Mpg123Api {
  int (*init)();
  mpg123_handle_t (*make)(const char *, int *);
  int (*open)(mpg123_handle_t, const char *);
  int (*getformat)(mpg123_handle_t, long *, int *, int *);
  int (*format_none)(mpg123_handle_t);
  int (*format)(mpg123_handle_t, long, int, int);
  int (*read)(mpg123_handle_t, void *, size_t, size_t *);
  int (*close)(mpg123_handle_t);
  void (*del)(mpg123_handle_t);
  bool ok = false;
};

constexpr int kMpg123Ok = 0;
constexpr int kMpg123Done = -12;
constexpr int kMpg123NewFormat = -11;
constexpr int kEncSigned16 = 0xD0;

Mpg123Api &mpg123_api() {
  static Mpg123Api api = [] {
    Mpg123Api a;
    void *lib = dlopen("libmpg123.so.0", RTLD_NOW | RTLD_GLOBAL);
    if (!lib) lib = dlopen("libmpg123.so", RTLD_NOW | RTLD_GLOBAL);
    if (!lib) return a;
    a.init = (int (*)())dlsym(lib, "mpg123_init");
    a.make = (mpg123_handle_t (*)(const char *, int *))dlsym(lib, "mpg123_new");
    a.open = (int (*)(mpg123_handle_t, const char *))dlsym(lib, "mpg123_open");
    a.getformat = (int (*)(mpg123_handle_t, long *, int *, int *))dlsym(
        lib, "mpg123_getformat");
    a.format_none = (int (*)(mpg123_handle_t))dlsym(lib, "mpg123_format_none");
    a.format =
        (int (*)(mpg123_handle_t, long, int, int))dlsym(lib, "mpg123_format");
    a.read = (int (*)(mpg123_handle_t, void *, size_t, size_t *))dlsym(
        lib, "mpg123_read");
    a.close = (int (*)(mpg123_handle_t))dlsym(lib, "mpg123_close");
    a.del = (void (*)(mpg123_handle_t))dlsym(lib, "mpg123_delete");
    a.ok = a.init && a.make && a.open && a.getformat && a.format_none &&
           a.format && a.read && a.close && a.del;
    if (a.ok) a.init();
    return a;
  }();
  return api;
}

}  // namespace

void sz_free(void *p) { free(p); }

int sz_decode_mp3(const char *path, int16_t **out, int64_t *out_len,
                  int32_t *rate, int32_t *channels) {
  Mpg123Api &api = mpg123_api();
  if (!api.ok) return -1;
  int err = 0;
  mpg123_handle_t h = api.make(nullptr, &err);
  if (!h) return -2;
  int rc = api.open(h, path);
  if (rc != kMpg123Ok) {
    api.del(h);
    return -3;
  }
  long r = 0;
  int ch = 0, enc = 0;
  rc = api.getformat(h, &r, &ch, &enc);
  if (rc != kMpg123Ok || r == 0) {
    api.close(h);
    api.del(h);
    return -4;
  }
  api.format_none(h);
  api.format(h, r, ch, kEncSigned16);

  std::vector<int16_t> samples;
  samples.reserve(1 << 18);
  std::vector<unsigned char> buf(1 << 16);
  size_t done = 0;
  for (;;) {
    rc = api.read(h, buf.data(), buf.size(), &done);
    if (done) {
      const int16_t *s = reinterpret_cast<const int16_t *>(buf.data());
      samples.insert(samples.end(), s, s + done / 2);
    }
    if (rc == kMpg123Done) break;
    if (rc != kMpg123Ok && rc != kMpg123NewFormat) {
      api.close(h);
      api.del(h);
      return -5;
    }
  }
  api.close(h);
  api.del(h);
  if (samples.empty()) return -6;

  auto *mem = static_cast<int16_t *>(malloc(samples.size() * sizeof(int16_t)));
  if (!mem) return -7;
  memcpy(mem, samples.data(), samples.size() * sizeof(int16_t));
  *out = mem;
  *out_len = static_cast<int64_t>(samples.size());
  *rate = static_cast<int32_t>(r);
  *channels = ch;
  return 0;
}

// ---------------------------------------------------------------------------
// RIFF/WAVE 16-bit PCM codec (hound equivalent; 16-bit-only reads mirroring
// src/lib.rs:404-406, mono 44.1k cache writes mirroring src/lib.rs:467-479).
// ---------------------------------------------------------------------------

int sz_read_wav(const char *path, int16_t **out, int64_t *out_len,
                int32_t *rate, int32_t *channels) {
  FILE *f = fopen(path, "rb");
  if (!f) return -1;
  unsigned char hdr[12];
  if (fread(hdr, 1, 12, f) != 12 || memcmp(hdr, "RIFF", 4) != 0 ||
      memcmp(hdr + 8, "WAVE", 4) != 0) {
    fclose(f);
    return -2;
  }
  uint16_t fmt_code = 0, ch = 0, bits = 0;
  uint32_t sr = 0;
  int16_t *data = nullptr;
  int64_t nsamples = 0;
  bool have_fmt = false, have_data = false;
  while (!(have_fmt && have_data)) {
    unsigned char chdr[8];
    if (fread(chdr, 1, 8, f) != 8) break;
    uint32_t size;
    memcpy(&size, chdr + 4, 4);
    if (memcmp(chdr, "fmt ", 4) == 0) {
      // A declared size below the 16-byte PCM header would make the field
      // reads below run past the buffer; an absurd size would throw
      // bad_alloc out of a batch worker thread (std::terminate).  Reject
      // both as malformed instead of trusting the header.
      if (size < 16 || size > (1u << 20)) break;
      std::vector<unsigned char> fmt(size);
      if (fread(fmt.data(), 1, size, f) != size) break;
      memcpy(&fmt_code, fmt.data(), 2);
      memcpy(&ch, fmt.data() + 2, 2);
      memcpy(&sr, fmt.data() + 4, 4);
      memcpy(&bits, fmt.data() + 14, 2);
      have_fmt = true;
    } else if (memcmp(chdr, "data", 4) == 0) {
      if (size == 0) {
        // A zero-length data chunk is a valid (empty) clip: the Python
        // reader (io/wav.py) returns 0 samples and downstream skips the
        // file as too short — the native path must not diverge by
        // rejecting the same input.  Allocate a 1-sample buffer so *out
        // is non-null/freeable; *out_len stays 0.
        data = static_cast<int16_t *>(malloc(sizeof(int16_t)));
        if (!data) {
          fclose(f);
          return -3;
        }
        nsamples = 0;
        have_data = true;
        continue;
      }
      nsamples = size / 2;
      data = static_cast<int16_t *>(malloc(size));
      if (!data || fread(data, 1, size, f) != size) {
        free(data);
        fclose(f);
        return -3;
      }
      have_data = true;
    } else {
      fseek(f, size, SEEK_CUR);
    }
    if (size % 2) fseek(f, 1, SEEK_CUR);
  }
  fclose(f);
  if (!have_fmt || !have_data) {
    free(data);
    return -4;
  }
  if (bits != 16 || (fmt_code != 1 && fmt_code != 0xFFFE)) {
    free(data);
    return -5;  // "Only 16-bit audio supported"
  }
  if (sr == 0 || sr > 0x7FFFFFFFu || ch == 0) {
    // rate 0 would divide by zero inside the resampler plan (SIGFPE kills
    // the whole batch-ingest process); a rate >= 2^31 would go NEGATIVE
    // through the int32 cast below and drive a wrapped ~2^64-element
    // allocation in the plan; channels 0 breaks downmix.
    free(data);
    return -6;
  }
  *out = data;
  *out_len = nsamples;
  *rate = static_cast<int32_t>(sr);
  *channels = ch;
  return 0;
}

int sz_write_wav(const char *path, const int16_t *data, int64_t len,
                 int32_t rate, int16_t channels) {
  // The RIFF size fields are u32: a payload past that bound would wrap
  // data_bytes and silently write a header that lies about the payload
  // (the Python twin's struct.pack('<I') raises for the same input).
  if (len < 0 || len > int64_t((0xFFFFFFFFu - 36u) / 2)) return -3;
  FILE *f = fopen(path, "wb");
  if (!f) return -1;
  uint32_t data_bytes = static_cast<uint32_t>(len * 2);
  uint32_t riff_size = 36 + data_bytes;
  uint32_t byte_rate = rate * channels * 2;
  uint16_t block_align = channels * 2;
  uint16_t bits = 16, pcm = 1;
  uint32_t fmt_size = 16;
  bool ok = fwrite("RIFF", 1, 4, f) == 4 && fwrite(&riff_size, 4, 1, f) == 1 &&
            fwrite("WAVE", 1, 4, f) == 4 && fwrite("fmt ", 1, 4, f) == 4 &&
            fwrite(&fmt_size, 4, 1, f) == 1 && fwrite(&pcm, 2, 1, f) == 1 &&
            fwrite(&channels, 2, 1, f) == 1 && fwrite(&rate, 4, 1, f) == 1 &&
            fwrite(&byte_rate, 4, 1, f) == 1 &&
            fwrite(&block_align, 2, 1, f) == 1 && fwrite(&bits, 2, 1, f) == 1 &&
            fwrite("data", 1, 4, f) == 4 && fwrite(&data_bytes, 4, 1, f) == 1 &&
            fwrite(data, 2, static_cast<size_t>(len), f) ==
                static_cast<size_t>(len);
  fclose(f);
  return ok ? 0 : -2;
}

// ---------------------------------------------------------------------------
// Threaded batch decode — the rayon-pool equivalent (src/lib.rs:541-547):
// fan paths across a std::thread pool, failures marked per-clip (the Python
// layer drops them silently, matching batch_resample's filter_map).
// ---------------------------------------------------------------------------

// ---------------------------------------------------------------------------
// FFT resampler exports (rubato-equivalent; see resample.h).
// ---------------------------------------------------------------------------

int sz_resample_i16(const int16_t *x, int64_t n, int32_t fs_in, int32_t fs_out,
                    int16_t **out, int64_t *out_len) {
  if (n < 0 || fs_in <= 0 || fs_out <= 0) {
    // fs_out == 0 would build a zero-output plan whose overlap-add writes
    // past an empty buffer (heap corruption); negative rates wrap the
    // plan's size_t allocations.
    return -2;
  }
  try {
    std::vector<int16_t> y = szr::resample_i16(x, size_t(n), fs_in, fs_out);
    // max(size,1): malloc(0) may return null, which would misreport an
    // empty (valid) result as an allocation failure; skip the memcpy for
    // the empty case (memcpy from a null vector data() is UB).
    auto *mem = static_cast<int16_t *>(
        malloc(std::max(y.size(), size_t(1)) * sizeof(int16_t)));
    if (!mem) return -1;
    if (!y.empty()) memcpy(mem, y.data(), y.size() * sizeof(int16_t));
    *out = mem;
    *out_len = static_cast<int64_t>(y.size());
    return 0;
  } catch (const std::exception &) {
    return -3;  // bad_alloc on a huge-but-valid input: fail, don't abort
  }
}

static int64_t downmix_raw(int16_t *samples, int64_t len, int channels) {
  // In-place on the decode buffer (output only shrinks): the previous
  // copy-into-a-vector formulation duplicated every clip wholesale on the
  // hot ingest path and doubled peak memory per worker thread.
  if (channels <= 1) return len;
  int64_t frames = len / channels;
  for (int64_t i = 0; i < frames; i++) {
    int32_t sum = 0;
    for (int c = 0; c < channels; c++) sum += samples[i * channels + c];
    samples[i] = int16_t(sum / channels);  // C++ trunc division == Rust
  }
  // ragged tail (Rust chunks() yields it too)
  int64_t rem = len - frames * channels;
  if (rem) {
    int32_t sum = 0;
    for (int64_t i = frames * channels; i < len; i++) sum += samples[i];
    samples[frames] = int16_t(sum / int32_t(rem));
    frames += 1;
  }
  return frames;
}

static void decode_one(const char *path, SzClip *clip) {
  size_t n = strlen(path);
  bool is_mp3 = n >= 4 && strncasecmp(path + n - 4, ".mp3", 4) == 0;
  bool is_wav = n >= 4 && strncasecmp(path + n - 4, ".wav", 4) == 0;
  int rc;
  try {
    if (is_mp3) {
      rc = sz_decode_mp3(path, &clip->samples, &clip->len, &clip->rate,
                         &clip->channels);
    } else if (is_wav) {
      rc = sz_read_wav(path, &clip->samples, &clip->len, &clip->rate,
                       &clip->channels);
    } else {
      rc = -100;
    }
  } catch (const std::exception &) {
    // bad_alloc (e.g. a multi-GB decode under memory pressure) on a pool
    // thread would std::terminate the whole process; mark THIS clip
    // failed instead — the Python fallback's _safe() drops exactly one
    // file for the same condition.
    rc = -8;
  }
  clip->status = rc;
  if (rc != 0) {
    clip->samples = nullptr;
    clip->len = 0;
  }
}

int sz_batch_decode(const char **paths, int32_t n, int32_t threads,
                    SzClip *out) {
  if (n <= 0) return 0;
  if (threads <= 0) threads = std::thread::hardware_concurrency();
  if (threads <= 0) threads = 1;  // hardware_concurrency() may return 0
  if (threads > n) threads = n;
  std::atomic<int32_t> next(0);
  std::vector<std::thread> pool;
  pool.reserve(threads);
  for (int t = 0; t < threads; ++t) {
    pool.emplace_back([&] {
      for (;;) {
        int32_t i = next.fetch_add(1);
        if (i >= n) break;
        decode_one(paths[i], &out[i]);
      }
    });
  }
  for (auto &th : pool) th.join();
  return 0;
}

// Full threaded ingest: decode → downmix → resample to target_rate, all on
// the std::thread pool — the complete load_and_resample_file pipeline
// (src/lib.rs:509-538) per clip, batched like batch_resample (:541-547).
int sz_batch_ingest(const char **paths, int32_t n, int32_t threads,
                    int32_t target_rate, SzClip *out) {
  if (n <= 0) return 0;
  if (target_rate <= 0) {
    // target 0 would build a zero-output resampler plan whose overlap-add
    // writes past an empty buffer (heap corruption); negative wraps the
    // plan's size_t allocations.  The input-rate twin of this guard lives
    // in sz_read_wav (-6).
    return -1;
  }
  if (threads <= 0) threads = std::thread::hardware_concurrency();
  if (threads <= 0) threads = 1;  // hardware_concurrency() may return 0
  if (threads > n) threads = n;
  std::atomic<int32_t> next(0);
  std::vector<std::thread> pool;
  pool.reserve(threads);
  for (int t = 0; t < threads; ++t) {
    pool.emplace_back([&] {
      for (;;) {
        int32_t i = next.fetch_add(1);
        if (i >= n) break;
        SzClip *clip = &out[i];
        decode_one(paths[i], clip);
        if (clip->status != 0) continue;
        try {
          // Downmix in place on the decode buffer (it only shrinks), then
          // resample straight from it — one clip copy instead of two.
          int64_t mono =
              downmix_raw(clip->samples, clip->len, clip->channels);
          std::vector<int16_t> res = szr::resample_i16(
              clip->samples, size_t(mono), clip->rate, target_rate);
          free(clip->samples);
          clip->samples = nullptr;
          // max(size,1): malloc(0) may return null, which would misreport
          // an empty (valid) clip as an allocation failure.
          auto *mem = static_cast<int16_t *>(
              malloc(std::max(res.size(), size_t(1)) * sizeof(int16_t)));
          if (!mem) {
            clip->status = -7;
            clip->len = 0;
            continue;
          }
          if (!res.empty())
            memcpy(mem, res.data(), res.size() * sizeof(int16_t));
          clip->samples = mem;
          clip->len = static_cast<int64_t>(res.size());
          clip->rate = target_rate;
          clip->channels = 1;
        } catch (const std::exception &) {
          // bad_alloc in the resampler (huge clip under memory pressure)
          // must fail THIS clip, not std::terminate the process.
          free(clip->samples);
          clip->samples = nullptr;
          clip->status = -8;
          clip->len = 0;
        }
      }
    });
  }
  for (auto &th : pool) th.join();
  return 0;
}

int sz_version() { return 2; }

}  // extern "C"
