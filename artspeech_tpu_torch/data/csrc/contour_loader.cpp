// Native batch contour loader for artspeech_tpu_torch (copy of
// native/contour_loader.cpp, scaling in float as numpy does).
//
// The data layer's hot host path is loading thousands of small .npy contour
// files per epoch (reference mitigates with an in-process lru_cache,
// phoneme_to_articulation/__init__.py:52-54). This library parses .npy
// directly, scales, arc-resamples to a fixed point count and fans the file IO
// out over a thread pool — one call loads a whole (frame x articulator)
// batch. Bound with ctypes by artspeech_tpu_torch/data/native.py, which
// builds it at first use with g++ into artspeech_tpu_torch/_build/.
//
// Each point is rounded to float and then divided by the float norm, as
// ``np.load(path).astype(np.float32) / norm`` computes it, so a file whose
// point count equals n_samples (the resample is then the identity) loads
// bit for bit as data/loaders.py:cached_load_articulator_array loads it.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// Minimal .npy reader: v1/v2 headers, little-endian f4/f8, C order, 2-D.
// Returns points as row-major (n, 2); accepts stored (n, 2) or (2, n).
bool read_npy_points(const char* path, std::vector<double>& xs,
                     std::vector<double>& ys) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  unsigned char magic[8];
  if (std::fread(magic, 1, 8, f) != 8 || std::memcmp(magic, "\x93NUMPY", 6)) {
    std::fclose(f);
    return false;
  }
  const int major = magic[6];
  uint32_t header_len = 0;
  if (major == 1) {
    unsigned char b[2];
    if (std::fread(b, 1, 2, f) != 2) { std::fclose(f); return false; }
    header_len = b[0] | (b[1] << 8);
  } else {
    unsigned char b[4];
    if (std::fread(b, 1, 4, f) != 4) { std::fclose(f); return false; }
    header_len = b[0] | (b[1] << 8) | (b[2] << 16) | (uint32_t(b[3]) << 24);
  }
  std::string header(header_len, '\0');
  if (std::fread(&header[0], 1, header_len, f) != header_len) {
    std::fclose(f);
    return false;
  }

  const bool f8 = header.find("<f8") != std::string::npos;
  const bool f4 = header.find("<f4") != std::string::npos;
  if ((!f4 && !f8) || header.find("'fortran_order': True") != std::string::npos) {
    std::fclose(f);
    return false;
  }
  size_t sp = header.find("'shape':");
  if (sp == std::string::npos) { std::fclose(f); return false; }
  long d0 = 0, d1 = 0;
  if (std::sscanf(header.c_str() + sp, "'shape': (%ld, %ld)", &d0, &d1) != 2) {
    std::fclose(f);
    return false;
  }
  const size_t count = size_t(d0) * size_t(d1);
  std::vector<unsigned char> raw(count * (f8 ? 8 : 4));
  if (std::fread(raw.data(), 1, raw.size(), f) != raw.size()) {
    std::fclose(f);
    return false;
  }
  std::fclose(f);

  auto at = [&](size_t i) -> double {
    if (f8) {
      double v;
      std::memcpy(&v, raw.data() + i * 8, 8);
      return v;
    }
    float v;
    std::memcpy(&v, raw.data() + i * 4, 4);
    return double(v);
  };

  long n;
  bool transposed;  // stored (2, n)
  if (d1 == 2) {
    n = d0;
    transposed = false;
  } else if (d0 == 2) {
    n = d1;
    transposed = true;
  } else {
    return false;
  }
  xs.resize(n);
  ys.resize(n);
  for (long i = 0; i < n; ++i) {
    if (transposed) {
      xs[i] = at(i);
      ys[i] = at(d1 + i);
    } else {
      xs[i] = at(2 * i);
      ys[i] = at(2 * i + 1);
    }
  }
  return true;
}

// Linear index-space resampling to m points (matches
// artspeech_tpu_torch.ops.resample.resample_linear_np); the identity when
// n == m.
void resample_linear(const std::vector<double>& v, long m,
                     std::vector<double>& out) {
  const long n = long(v.size());
  out.resize(m);
  if (n == 1) {
    for (long j = 0; j < m; ++j) out[j] = v[0];
    return;
  }
  for (long j = 0; j < m; ++j) {
    const double pos = double(j) * double(n - 1) / double(m - 1);
    const long i0 = long(pos);
    const long i1 = i0 + 1 < n ? i0 + 1 : n - 1;
    const double w = pos - double(i0);
    out[j] = v[i0] * (1.0 - w) + v[i1] * w;
  }
}

}  // namespace

extern "C" {

// Load n_files npy contours; write (n_files, 2, n_samples) float32 into out
// (x row then y row per file, matching the (2, D) contour layout), scaled by
// 1/norm_value (in float). ok[i] = 1 on success; orig_len[i] (optional, may be null)
// receives the file's original point count. Runs on up to n_threads threads.
void load_contours_batch(const char** paths, int64_t n_files,
                         int64_t n_samples, float norm_value, float* out,
                         uint8_t* ok, int32_t n_threads,
                         int64_t* orig_len) {
  if (n_threads <= 0) {
    n_threads = int32_t(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 4;
  }
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    std::vector<double> xs, ys, rx, ry;
    for (;;) {
      const int64_t i = next.fetch_add(1);
      if (i >= n_files) return;
      ok[i] = 0;
      if (orig_len) orig_len[i] = 0;
      if (!read_npy_points(paths[i], xs, ys)) continue;
      if (orig_len) orig_len[i] = int64_t(xs.size());
      resample_linear(xs, n_samples, rx);
      resample_linear(ys, n_samples, ry);
      float* dst = out + i * 2 * n_samples;
      for (int64_t j = 0; j < n_samples; ++j) {
        dst[j] = float(rx[j]) / norm_value;
        dst[n_samples + j] = float(ry[j]) / norm_value;
      }
      ok[i] = 1;
    }
  };
  std::vector<std::thread> threads;
  const int32_t k = n_threads < n_files ? n_threads : int32_t(n_files);
  threads.reserve(k);
  for (int32_t t = 0; t < k; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

}  // extern "C"
