// Native data-loader library of vrdd_tpu_torch (a copy of the JAX
// package's vrdd_tpu/native/vrdd_io.cpp, which stays its own).
//
// C++ implementations of the binary-format readers (the reference implements
// these as C++ host code, volumeRender.cpp:538-997). Exposed through a plain
// C ABI consumed via ctypes (vrdd_tpu_torch/io/native.py, which builds it
// with g++ at first use); the Python readers in vrdd_tpu_torch/io/formats.py
// are the behavioral specification and fallback.
//
// All formats are little-endian; bool on disk is 1 byte. Validation mirrors
// the reference's checks (span ordering, frequency ranges, sum-to-one) and is
// reported through negative return codes instead of printf + exit.

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kErrOpen = -1;
constexpr int kErrTruncated = -2;
constexpr int kErrRange = -3;
constexpr int kErrDuplicate = -4;

struct File {
  FILE* fp = nullptr;
  explicit File(const char* path) { fp = std::fopen(path, "rb"); }
  ~File() {
    if (fp) std::fclose(fp);
  }
  bool ok() const { return fp != nullptr; }
  template <typename T>
  bool read(T* out, size_t n = 1) {
    return std::fread(out, sizeof(T), n, fp) == n;
  }
  bool skip(long bytes) { return std::fseek(fp, bytes, SEEK_CUR) == 0; }
};

// bins-major load helpers (vrdd_read_histograms_bins_major)

inline uint16_t to_bf16(float v) {
  uint32_t bits;
  std::memcpy(&bits, &v, 4);
  if ((bits & 0x7FFFFFFFu) > 0x7F800000u) return 0x7FC0u;
  // round to nearest even on the dropped 16 bits
  return static_cast<uint16_t>((bits + 0x7FFFu + ((bits >> 16) & 1u)) >> 16);
}

template <typename T, typename Cvt>
void transpose_layer(const float* layer, long ny, long nx, long n_bins,
                     T* out_z, Cvt cvt) {
  for (long y = 0; y < ny; ++y) {
    const float* row = layer + static_cast<size_t>(y) * nx * n_bins;
    for (long b = 0; b < n_bins; ++b) {
      T* dst = out_z + (b * ny + y) * nx;
      const float* src = row + b;
      for (long x = 0; x < nx; ++x) dst[x] = cvt(src[x * n_bins]);
    }
  }
}

}  // namespace

extern "C" {

// ----------------------------------------------------------- raw blob (fmt 1)

int vrdd_read_raw(const char* path, long count, float* out) {
  File f(path);
  if (!f.ok()) return kErrOpen;
  if (!f.read(out, static_cast<size_t>(count))) return kErrTruncated;
  return 0;
}

// ----------------------------------------------------- codebooks (fmts 2 & 5)

// Header: <nSteps:i32><n:i32>; per entry: <spanId:i32><templateId:i32>
// <shift:i32><flip:u8><nErrors:i32><nErrors x i32><nErrors x f64>.

int vrdd_codebook_count(const char* path) {
  File f(path);
  if (!f.ok()) return kErrOpen;
  int32_t n_steps = 0, n = 0;
  if (!f.read(&n_steps) || !f.read(&n)) return kErrTruncated;
  return n;
}

int vrdd_read_codebook(const char* path, int n_bins, int max_errors,
                       int32_t* codebook, int32_t* ebins, float* evals,
                       int32_t* span_ids) {
  File f(path);
  if (!f.ok()) return kErrOpen;
  int32_t n_steps = 0, n = 0;
  if (!f.read(&n_steps) || !f.read(&n)) return kErrTruncated;
  std::vector<int32_t> ids;
  std::vector<double> vals;
  for (int32_t i = 0; i < n; ++i) {
    int32_t span_id, tid, shift, ne;
    uint8_t flip;
    if (!f.read(&span_id) || !f.read(&tid) || !f.read(&shift) ||
        !f.read(&flip) || !f.read(&ne))
      return kErrTruncated;
    if (ne < 0 || ne > n_bins) return kErrRange;  // volumeRender.cpp:611, 833
    span_ids[i] = span_id;
    codebook[i * 4 + 0] = tid;
    codebook[i * 4 + 1] = shift;
    codebook[i * 4 + 2] = flip ? 1 : 0;
    codebook[i * 4 + 3] = ne;
    ids.resize(ne);
    vals.resize(ne);
    if (ne) {
      if (!f.read(ids.data(), ne) || !f.read(vals.data(), ne))
        return kErrTruncated;
    }
    // the decode scatter-adds all sparse errors then clamps ONCE, which is
    // equivalent to the reference's clamp-after-each-add
    // (volumeRender_kernel.cu:817-825) only when bin ids are unique per
    // histogram; reject duplicates (and out-of-range ids,
    // volumeRender.cpp:701-707) up front instead of decoding differently.
    for (int e = 0; e < ne; ++e) {
      if (ids[e] < 0 || ids[e] >= n_bins) return kErrRange;
      for (int e2 = 0; e2 < e; ++e2)
        if (ids[e2] == ids[e]) return kErrDuplicate;
    }
    for (int e = 0; e < ne && e < max_errors; ++e) {
      ebins[i * max_errors + e] = ids[e];
      evals[i * max_errors + e] = static_cast<float>(vals[e]);
    }
  }
  return n;
}

// ----------------------------------------------------- templates (fmts 3 & 7)

int vrdd_templates_count(const char* path) {
  File f(path);
  if (!f.ok()) return kErrOpen;
  int32_t n = 0;
  if (!f.read(&n)) return kErrTruncated;
  return n;
}

int vrdd_read_templates(const char* path, int n_bins, float* out) {
  File f(path);
  if (!f.ok()) return kErrOpen;
  int32_t n = 0;
  if (!f.read(&n)) return kErrTruncated;
  std::vector<double> freqs(n_bins);
  for (int32_t i = 0; i < n; ++i) {
    if (!f.skip(8 * 6)) return kErrTruncated;  // limits, ignored
    if (!f.read(freqs.data(), n_bins)) return kErrTruncated;
    for (int b = 0; b < n_bins; ++b) {
      if (freqs[b] < 0.0 || freqs[b] > 1.0) return kErrRange;
      out[i * n_bins + b] = static_cast<float>(freqs[b]);
    }
  }
  return n;
}

// ------------------------------------------------------------ span list (4)

// On-disk interleave: lowX, highX, lowY, highY, lowZ, highZ
// (the reference reads them in that order, volumeRender.cpp:734-739).

int vrdd_span_count(const char* path) {
  File f(path);
  if (!f.ok()) return kErrOpen;
  int32_t n = 0;
  if (!f.read(&n)) return kErrTruncated;
  return n;
}

int vrdd_read_span_list(const char* path, int32_t* low, int32_t* high) {
  File f(path);
  if (!f.ok()) return kErrOpen;
  int32_t n = 0;
  if (!f.read(&n)) return kErrTruncated;
  int32_t rec[6];
  for (int32_t i = 0; i < n; ++i) {
    if (!f.read(rec, 6)) return kErrTruncated;
    const int32_t lx = rec[0], hx = rec[1], ly = rec[2], hy = rec[3],
                  lz = rec[4], hz = rec[5];
    if (lx > hx || ly > hy || lz > hz || lx < 0 || ly < 0 || lz < 0 ||
        hx < 0 || hy < 0 || hz < 0)
      return kErrRange;  // checkSpanLimit, volumeRender.cpp:693-699
    low[i * 3 + 0] = lx;
    low[i * 3 + 1] = ly;
    low[i * 3 + 2] = lz;
    high[i * 3 + 0] = hx;
    high[i * 3 + 1] = hy;
    high[i * 3 + 2] = hz;
  }
  return n;
}

// ------------------------------------------------- simple histogram trio (6)

int vrdd_simple_count(const char* path) {
  File f(path);
  if (!f.ok()) return kErrOpen;
  int32_t n = 0;
  if (!f.read(&n)) return kErrTruncated;
  return n;
}

int vrdd_read_simple(const char* counts_path, const char* ids_path,
                     const char* freqs_path, int n_bins, int32_t* low,
                     int32_t* high, int32_t* bin_ids, float* freqs,
                     int32_t* counts) {
  File fc(counts_path), fb(ids_path), ff(freqs_path);
  if (!fc.ok() || !fb.ok() || !ff.ok()) return kErrOpen;
  int32_t n = 0;
  if (!fc.read(&n)) return kErrTruncated;
  std::vector<int32_t> ids(n_bins);
  std::vector<double> fr(n_bins);
  for (int32_t i = 0; i < n; ++i) {
    int32_t span[6];
    if (!fc.read(span, 6)) return kErrTruncated;
    std::memcpy(low + i * 3, span, 3 * sizeof(int32_t));
    std::memcpy(high + i * 3, span + 3, 3 * sizeof(int32_t));
    int32_t c = 0;
    if (!fc.read(&c)) return kErrTruncated;
    if (c < 0 || c > n_bins) return kErrRange;
    counts[i] = c;
    if (c) {
      if (!fb.read(ids.data(), c) || !ff.read(fr.data(), c))
        return kErrTruncated;
    }
    double total = 0.0;
    for (int e = 0; e < c; ++e) {
      if (ids[e] < 0 || ids[e] > n_bins || fr[e] < 0.0 || fr[e] > 1.0)
        return kErrRange;  // checkHistogram, volumeRender.cpp:701-707
      bin_ids[i * n_bins + e] = ids[e];
      freqs[i * n_bins + e] = static_cast<float>(fr[e]);
      total += fr[e];
    }
    if (c && (total > 1.000001 || total < 0.999999))
      return kErrRange;  // volumeRender.cpp:940-942
  }
  return n;
}

// ------------------------------------------------ PPM golden images (fmt 8)
//
// The reference's benchmark/golden path writes the rendered frame as a P6
// PPM and compares against a stored reference with a per-pixel epsilon and
// an outlier budget (sdkSavePPM4ub / sdkComparePPM, volumeRender.cpp:
// 1073-1083, tolerances :57-58). vrdd_tpu/io/formats.py is the spec; these
// are the native equivalents for the load-bearing benchmark loop.

// (H, W, 4) RGBA8 -> P6 file, alpha dropped. 0 on success.
int vrdd_write_ppm(const char* path, int w, int h, const uint8_t* rgba) {
  FILE* fp = std::fopen(path, "wb");
  if (!fp) return kErrOpen;
  std::fprintf(fp, "P6\n%d %d\n255\n", w, h);
  std::vector<uint8_t> row(static_cast<size_t>(w) * 3);
  for (int y = 0; y < h; ++y) {
    const uint8_t* src = rgba + static_cast<size_t>(y) * w * 4;
    for (int x = 0; x < w; ++x) std::memcpy(&row[x * 3u], src + x * 4, 3);
    if (std::fwrite(row.data(), 1, row.size(), fp) != row.size()) {
      std::fclose(fp);
      return kErrTruncated;
    }
  }
  return std::fclose(fp) == 0 ? 0 : kErrTruncated;
}

namespace {

// P6 header: magic, optional #-comments, width height, maxval 255.
int ppm_header(FILE* fp, int* w, int* h) {
  char magic[3] = {0};
  if (std::fscanf(fp, "%2s", magic) != 1 || std::strcmp(magic, "P6") != 0)
    return kErrRange;
  int vals[3];
  for (int i = 0; i < 3;) {
    int c = std::fgetc(fp);
    if (c == EOF) return kErrTruncated;
    if (std::isspace(c)) continue;
    if (c == '#') {  // comment line
      while (c != '\n' && c != EOF) c = std::fgetc(fp);
      continue;
    }
    std::ungetc(c, fp);
    if (std::fscanf(fp, "%d", &vals[i]) != 1) return kErrTruncated;
    ++i;
  }
  if (vals[2] != 255) return kErrRange;
  if (std::fgetc(fp) == EOF) return kErrTruncated;  // single ws after maxval
  *w = vals[0];
  *h = vals[1];
  return 0;
}

}  // namespace

// Header probe. 0 on success.
int vrdd_ppm_size(const char* path, int* w, int* h) {
  File f(path);
  if (!f.ok()) return kErrOpen;
  return ppm_header(f.fp, w, h);
}

// Read pixel payload into (h, w, 3) u8. 0 on success.
int vrdd_read_ppm(const char* path, int w, int h, uint8_t* rgb) {
  File f(path);
  if (!f.ok()) return kErrOpen;
  int fw = 0, fh = 0;
  int rc = ppm_header(f.fp, &fw, &fh);
  if (rc != 0) return rc;
  if (fw != w || fh != h) return kErrRange;
  if (!f.read(rgb, static_cast<size_t>(w) * h * 3)) return kErrTruncated;
  return 0;
}

// Compare an in-memory (H, W, 3) u8 image against a reference PPM file:
// returns the number of pixels with ANY channel differing by more than
// epsilon (the sdkComparePPM model; pass/fail = outliers <= threshold *
// w * h, left to the caller), or a negative error code.
long vrdd_compare_ppm(const uint8_t* rgb, const char* ref_path, int w, int h,
                      float epsilon) {
  std::vector<uint8_t> ref(static_cast<size_t>(w) * h * 3);
  int rc = vrdd_read_ppm(ref_path, w, h, ref.data());
  if (rc != 0) return rc;
  long outliers = 0;
  for (long p = 0; p < static_cast<long>(w) * h; ++p) {
    for (int c = 0; c < 3; ++c) {
      int d = static_cast<int>(rgb[p * 3 + c]) - static_cast<int>(ref[p * 3 + c]);
      if (d > epsilon || -d > epsilon) {
        ++outliers;
        break;
      }
    }
  }
  return outliers;
}



// --------------------------------- bins-major histogram load (device layout)

// Read a voxel-major / bins-minor histogram blob (the reference's on-disk
// layout for block histograms: Z*Y*X records of n_bins floats,
// volumeRender.cpp:583-597) and emit it TRANSPOSED to the framework's
// bins-MAJOR device layout (nz, n_bins, ny, nx) — the layout the fused
// in-kernel decode streams (kernels/slice_kernel.py pallas_hist_render:
// a voxel's bins sit one (ny, nx) plane apart). Up to 8 threads each take
// a range of z-layers with a file handle of their own; a layer is read in
// one fread, then transposed a voxel row at a time: for each bin the row's
// nx values are gathered from the cache-resident row and stored
// contiguously, so every store stream is sequential. No second full-size
// array exists.
// out_bf16 != 0: emit IEEE bfloat16 (round-to-nearest-even, NaN to the
// quiet 0x7FC0, as torch rounds) into `out` reinterpreted as uint16 —
// bf16 histogram storage is the kernel's throughput default (half the
// HBM stream).

int vrdd_read_histograms_bins_major(const char* path, long nz, long ny,
                                    long nx, long n_bins, int out_bf16,
                                    void* out) {
  const size_t plane = static_cast<size_t>(ny) * nx;
  const size_t layer_floats = plane * n_bins;
  // z-ranges on up to 8 threads, each with its own file handle and layer
  const long n_threads = std::max(1L, std::min<long>(
      {nz, 8L, static_cast<long>(std::thread::hardware_concurrency())}));
  std::vector<int> rcs(n_threads, 0);
  auto work = [&](long t) {
    const long z0 = nz * t / n_threads, z1 = nz * (t + 1) / n_threads;
    File f(path);
    if (!f.ok()) {
      rcs[t] = kErrOpen;
      return;
    }
    if (std::fseek(f.fp, static_cast<long>(z0 * layer_floats * 4),
                   SEEK_SET) != 0) {
      rcs[t] = kErrTruncated;
      return;
    }
    std::vector<float> layer(layer_floats);
    for (long z = z0; z < z1; ++z) {
      if (!f.read(layer.data(), layer.size())) {
        rcs[t] = kErrTruncated;
        return;
      }
      const size_t off = static_cast<size_t>(z) * n_bins * plane;
      if (out_bf16) {
        transpose_layer(layer.data(), ny, nx, n_bins,
                        static_cast<uint16_t*>(out) + off, to_bf16);
      } else {
        transpose_layer(layer.data(), ny, nx, n_bins,
                        static_cast<float*>(out) + off,
                        [](float v) { return v; });
      }
    }
  };
  std::vector<std::thread> pool;
  for (long t = 1; t < n_threads; ++t) pool.emplace_back(work, t);
  work(0);
  for (auto& th : pool) th.join();
  for (int rc : rcs) {
    if (rc != 0) return rc;
  }
  return 0;
}

}  // extern "C"
