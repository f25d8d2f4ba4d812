// Native IO runtime of loam_tpu_torch: point-cloud readers, spherical
// range-image projection, and a threaded prefetching scan loader.
//
// A copy of loam_tpu's io/native/loam_io.cpp, built into this package's own
// directory so that the two packages never share a library. LiDAR pipelines
// are commonly host-IO bound: parsing PCD/KITTI files and projecting
// unordered clouds into the (scan_lines x points_per_line) range-image
// layout the extractor consumes (reference input convention:
// loam/include/loam/features.h:8-10) costs more than the device step once
// the kernels are fast, so it runs here in C++ with a pthread prefetch
// pipeline, exposed to Python via ctypes (loam_tpu_torch/io/native.py).
// Every entry point has a NumPy fallback. One divergence from the original:
// the packed projection writes nothing for fewer than two scan lines, as
// the packed codec (io/packed.py) refuses them.
//
// Build: c++ -O3 -shared -fPIC -std=c++17 -o libloam_io.so loam_io.cpp -lpthread
// (driven by loam_tpu_torch/io/native.py on first use).

#include <atomic>
#include <cctype>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Readers. Return number of points written (<= max_points), or -1 on error.
// Output layout: interleaved xyz float32.
// ---------------------------------------------------------------------------

// KITTI velodyne .bin: little-endian float32 records of (x, y, z, intensity).
// Bulk-read in ~1 MB blocks: the original 16-byte-per-fread loop spent
// ~8 ms/frame in stdio call overhead (65k calls) — the dataset-mode host
// bottleneck once upload and compute were pipelined (round 5).
int loam_read_kitti_bin(const char* path, float* out, int max_points) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  constexpr int kBlockRecs = 65536;  // 1 MiB of (x,y,z,i) records
  std::vector<float> buf((size_t)kBlockRecs * 4);
  int n = 0;
  while (n < max_points) {
    int want = kBlockRecs < max_points - n ? kBlockRecs : max_points - n;
    size_t got = std::fread(buf.data(), sizeof(float) * 4, want, f);
    for (size_t i = 0; i < got; i++) {
      out[3 * (n + (int)i) + 0] = buf[4 * i + 0];
      out[3 * (n + (int)i) + 1] = buf[4 * i + 1];
      out[3 * (n + (int)i) + 2] = buf[4 * i + 2];
    }
    n += (int)got;
    if (got < (size_t)want) break;
  }
  std::fclose(f);
  return n;
}

namespace {

struct PcdHeader {
  std::vector<std::string> fields;
  std::vector<int> sizes;
  std::vector<char> types;
  std::vector<int> counts;
  long points = -1;
  bool binary = false;
  bool ok = false;
  long data_offset = 0;
};

PcdHeader parse_pcd_header(FILE* f) {
  PcdHeader h;
  char line[4096];
  while (std::fgets(line, sizeof(line), f)) {
    std::string s(line);
    auto starts = [&](const char* p) { return s.rfind(p, 0) == 0; };
    auto split_rest = [&](std::vector<std::string>& outv) {
      outv.clear();
      size_t sp = s.find(' ');
      if (sp == std::string::npos) return;
      std::string rest = s.substr(sp + 1);
      char* tok = std::strtok(rest.data(), " \t\r\n");
      while (tok) {
        outv.emplace_back(tok);
        tok = std::strtok(nullptr, " \t\r\n");
      }
    };
    if (starts("FIELDS")) {
      split_rest(h.fields);
    } else if (starts("SIZE")) {
      std::vector<std::string> v;
      split_rest(v);
      for (auto& x : v) h.sizes.push_back(std::atoi(x.c_str()));
    } else if (starts("TYPE")) {
      std::vector<std::string> v;
      split_rest(v);
      for (auto& x : v) h.types.push_back(x.empty() ? 'F' : x[0]);
    } else if (starts("COUNT")) {
      std::vector<std::string> v;
      split_rest(v);
      for (auto& x : v) h.counts.push_back(std::atoi(x.c_str()));
    } else if (starts("POINTS")) {
      h.points = std::atol(s.substr(7).c_str());
    } else if (starts("DATA")) {
      h.binary = s.find("binary") != std::string::npos;
      h.ok = true;
      h.data_offset = std::ftell(f);
      break;
    }
  }
  if (h.counts.empty()) h.counts.assign(h.fields.size(), 1);
  return h;
}

}  // namespace

// PCD reader: ascii and (non-compressed) binary, x/y/z fields of size 4
// (float32) or 8 (float64). Extra fields are skipped.
int loam_read_pcd(const char* path, float* out, int max_points) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  PcdHeader h = parse_pcd_header(f);
  if (!h.ok || h.points < 0 || h.fields.size() != h.sizes.size()) {
    std::fclose(f);
    return -1;
  }
  int xi = -1, yi = -1, zi = -1;
  for (size_t i = 0; i < h.fields.size(); i++) {
    if (h.fields[i] == "x") xi = (int)i;
    if (h.fields[i] == "y") yi = (int)i;
    if (h.fields[i] == "z") zi = (int)i;
  }
  if (xi < 0 || yi < 0 || zi < 0) {
    std::fclose(f);
    return -1;
  }
  long n_read = h.points < (long)max_points ? h.points : (long)max_points;
  int n = 0;
  if (h.binary) {
    long stride = 0;
    std::vector<long> offsets(h.fields.size());
    for (size_t i = 0; i < h.fields.size(); i++) {
      offsets[i] = stride;
      stride += (long)h.sizes[i] * h.counts[i];
    }
    // bulk-read ~1 MiB blocks of records (per-record fread costs ~100 ns
    // of stdio overhead each — ~7 ms/frame at Ouster-64 density)
    long block_recs = stride > 0 ? (1L << 20) / stride : 0;
    if (block_recs < 1) block_recs = 1;
    std::vector<unsigned char> buf((size_t)block_recs * stride);
    const int idx[3] = {xi, yi, zi};
    while (n < n_read) {
      long want = block_recs < n_read - n ? block_recs : n_read - n;
      size_t got = std::fread(buf.data(), stride, want, f);
      for (size_t r = 0; r < got; r++) {
        const unsigned char* rec = buf.data() + r * stride;
        for (int c = 0; c < 3; c++) {
          const unsigned char* p = rec + offsets[idx[c]];
          float v;
          if (h.sizes[idx[c]] == 8) {
            double d;
            std::memcpy(&d, p, 8);
            v = (float)d;
          } else {
            std::memcpy(&v, p, 4);
          }
          out[3 * (n + (long)r) + c] = v;
        }
      }
      n += (int)got;
      if (got < (size_t)want) break;
    }
  } else {
    char line[8192];
    while (n < n_read && std::fgets(line, sizeof(line), f)) {
      std::vector<double> vals;
      char* tok = std::strtok(line, " \t\r\n");
      while (tok) {
        vals.push_back(std::atof(tok));
        tok = std::strtok(nullptr, " \t\r\n");
      }
      if ((int)vals.size() < (int)h.fields.size()) continue;
      out[3 * n + 0] = (float)vals[xi];
      out[3 * n + 1] = (float)vals[yi];
      out[3 * n + 2] = (float)vals[zi];
      n++;
    }
  }
  std::fclose(f);
  return n;
}

// Write points as an uncompressed binary PCD (fields x y z float32).
// Returns 0 on success, -1 on error.
int loam_write_pcd(const char* path, const float* pts, int n) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  std::fprintf(f,
               "VERSION .7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\n"
               "COUNT 1 1 1\nWIDTH %d\nHEIGHT 1\n"
               "VIEWPOINT 0 0 0 1 0 0 0\nPOINTS %d\nDATA binary\n",
               n, n);
  size_t wrote = std::fwrite(pts, sizeof(float) * 3, (size_t)n, f);
  std::fclose(f);
  return wrote == (size_t)n ? 0 : -1;
}

// ---------------------------------------------------------------------------
// Spherical range-image projection: unordered cloud -> (L, P, 3) grid in the
// row-major layout the extractor consumes. Cells keep the NEAREST return;
// empty cells are (0,0,0) (range 0 => out-of-range-invalidated downstream).
// ---------------------------------------------------------------------------
void loam_project_range_image(const float* pts, int n, int scan_lines,
                              int points_per_line, float elev_lo,
                              float elev_hi, float* out /*L*P*3*/) {
  const long total = (long)scan_lines * points_per_line;
  std::memset(out, 0, sizeof(float) * total * 3);
  std::vector<float> best(total, 1e30f);
  const float two_pi = 6.28318530717958647692f;
  for (int i = 0; i < n; i++) {
    const float x = pts[3 * i], y = pts[3 * i + 1], z = pts[3 * i + 2];
    const float r2 = x * x + y * y + z * z;
    if (r2 <= 1e-12f) continue;
    const float rxy = std::sqrt(x * x + y * y);
    const float elev = std::atan2(z, rxy);
    float az = std::atan2(y, x);
    if (az < 0) az += two_pi;
    int row = (int)std::lround((elev - elev_lo) / (elev_hi - elev_lo) *
                               (scan_lines - 1));
    if (row < 0 || row >= scan_lines) continue;
    int col = (int)(az / two_pi * points_per_line);
    if (col >= points_per_line) col = points_per_line - 1;
    const long cell = (long)row * points_per_line + col;
    if (r2 < best[cell]) {
      best[cell] = r2;
      out[3 * cell + 0] = x;
      out[3 * cell + 1] = y;
      out[3 * cell + 2] = z;
    }
  }
}

// ---------------------------------------------------------------------------
// Packed spherical projection: unordered cloud -> (4, L, P) uint8 planes
// [r_lo, r_hi, az8, el8] — a 4-byte/point wire format, a third of the
// 12 B/pt of raw xyz, for when host->device upload bandwidth rather than
// compute bounds file-fed throughput. Quantization is below LiDAR sensor
// noise:
//   range:  uint16 r/r_max steps (r_max=131.07 m -> 2 mm)
//   az:     offset within the 2*pi/P cell, 8 bits -> 1.2e-5 rad max error
//   elev:   offset within the (hi-lo)/(L-1) cell, 8 bits -> 1.7e-5 rad
// Empty cells are all-zero (range 0 => invalidated downstream, exactly like
// the float path). Device-side decode: loam_tpu_torch/io/packed.py
// (elementwise, on the tensor's device).
// ---------------------------------------------------------------------------
void loam_project_packed(const float* pts, int n, int scan_lines,
                         int points_per_line, float elev_lo, float elev_hi,
                         float r_max, unsigned char* out /*4*L*P*/) {
  const long total = (long)scan_lines * points_per_line;
  std::memset(out, 0, (size_t)total * 4);
  // the elevation cell is (hi - lo) / (L - 1): no cell below two lines
  if (scan_lines < 2) return;
  std::vector<float> best(total, 1e30f);
  const float two_pi = 6.28318530717958647692f;
  const float cell_h = (elev_hi - elev_lo) / (scan_lines - 1);
  unsigned char* r_lo = out;
  unsigned char* r_hi = out + total;
  unsigned char* az8 = out + 2 * total;
  unsigned char* el8 = out + 3 * total;
  for (int i = 0; i < n; i++) {
    const float x = pts[3 * i], y = pts[3 * i + 1], z = pts[3 * i + 2];
    const float r2 = x * x + y * y + z * z;
    if (r2 <= 1e-12f) continue;
    const float rxy = std::sqrt(x * x + y * y);
    const float elev = std::atan2(z, rxy);
    float az = std::atan2(y, x);
    if (az < 0) az += two_pi;
    int row = (int)std::lround((elev - elev_lo) / (elev_hi - elev_lo) *
                               (scan_lines - 1));
    if (row < 0 || row >= scan_lines) continue;
    int col = (int)(az / two_pi * points_per_line);
    if (col >= points_per_line) col = points_per_line - 1;
    const long cell = (long)row * points_per_line + col;
    if (r2 >= best[cell]) continue;
    best[cell] = r2;
    const float r = std::sqrt(r2);
    long rq = std::lround(r / r_max * 65535.0f);
    if (rq < 0) rq = 0;
    if (rq > 65535) rq = 65535;
    // a real sub-min-range return must not quantize to the empty sentinel
    if (rq == 0) rq = 1;
    const float az_off = az - col * (two_pi / points_per_line);
    int aq = (int)(az_off * points_per_line / two_pi * 256.0f);
    if (aq < 0) aq = 0;
    if (aq > 255) aq = 255;
    const float el_off = elev - (elev_lo + row * cell_h);
    int eq = (int)((el_off / cell_h + 0.5f) * 256.0f);
    if (eq < 0) eq = 0;
    if (eq > 255) eq = 255;
    r_lo[cell] = (unsigned char)(rq & 0xff);
    r_hi[cell] = (unsigned char)(rq >> 8);
    az8[cell] = (unsigned char)aq;
    el8[cell] = (unsigned char)eq;
  }
}

// ---------------------------------------------------------------------------
// Prefetching scan loader: worker threads read + project scans ahead of the
// consumer into a bounded queue (classic host-side input pipeline; keeps the
// accelerator fed). Files may be .bin (KITTI) or .pcd. In packed mode the
// workers emit the 4-byte/point wire format above instead of float xyz.
// ---------------------------------------------------------------------------
namespace {

struct Loader {
  std::vector<std::string> paths;
  int scan_lines, points_per_line;
  float elev_lo, elev_hi;
  int max_raw_points;
  size_t frame_floats;
  bool packed = false;
  float r_max = 131.07f;
  size_t frame_bytes;  // bytes per queued frame (float or packed)

  std::mutex mu;
  std::condition_variable cv_produce, cv_consume;
  std::queue<std::pair<size_t, std::vector<unsigned char>>> ready;  // (index, frame)
  size_t next_to_read = 0;    // next file index workers claim
  size_t next_to_emit = 0;    // next index the consumer expects
  size_t capacity;
  std::atomic<bool> stop{false};
  std::vector<std::thread> workers;

  void work() {
    std::vector<float> raw((size_t)max_raw_points * 3);
    while (!stop.load()) {
      size_t idx;
      {
        std::lock_guard<std::mutex> lk(mu);
        if (next_to_read >= paths.size()) return;
        idx = next_to_read++;
      }
      const std::string& p = paths[idx];
      int n;
      if (p.size() > 4 && p.compare(p.size() - 4, 4, ".pcd") == 0) {
        n = loam_read_pcd(p.c_str(), raw.data(), max_raw_points);
      } else {
        n = loam_read_kitti_bin(p.c_str(), raw.data(), max_raw_points);
      }
      std::vector<unsigned char> grid(frame_bytes, 0);
      if (n > 0) {
        if (packed) {
          loam_project_packed(raw.data(), n, scan_lines, points_per_line,
                              elev_lo, elev_hi, r_max, grid.data());
        } else {
          loam_project_range_image(raw.data(), n, scan_lines, points_per_line,
                                   elev_lo, elev_hi,
                                   reinterpret_cast<float*>(grid.data()));
        }
      }
      std::unique_lock<std::mutex> lk(mu);
      cv_produce.wait(lk, [&] {
        return stop.load() || ready.size() < capacity ||
               idx == next_to_emit;  // never block the in-order frame
      });
      if (stop.load()) return;
      ready.emplace(idx, std::move(grid));
      cv_consume.notify_all();
    }
  }
};

}  // namespace

void* loam_loader_create_ex(const char** paths, int n_paths, int scan_lines,
                            int points_per_line, float elev_lo, float elev_hi,
                            int max_raw_points, int n_threads, int queue_cap,
                            int packed, float r_max) {
  auto* L = new Loader();
  for (int i = 0; i < n_paths; i++) L->paths.emplace_back(paths[i]);
  L->scan_lines = scan_lines;
  L->points_per_line = points_per_line;
  L->elev_lo = elev_lo;
  L->elev_hi = elev_hi;
  L->max_raw_points = max_raw_points;
  L->frame_floats = (size_t)scan_lines * points_per_line * 3;
  L->packed = packed != 0;
  L->r_max = r_max;
  L->frame_bytes = L->packed ? (size_t)scan_lines * points_per_line * 4
                             : L->frame_floats * sizeof(float);
  L->capacity = queue_cap > 0 ? queue_cap : 4;
  int nt = n_threads > 0 ? n_threads : 2;
  for (int i = 0; i < nt; i++) L->workers.emplace_back(&Loader::work, L);
  return L;
}

void* loam_loader_create(const char** paths, int n_paths, int scan_lines,
                         int points_per_line, float elev_lo, float elev_hi,
                         int max_raw_points, int n_threads, int queue_cap) {
  return loam_loader_create_ex(paths, n_paths, scan_lines, points_per_line,
                               elev_lo, elev_hi, max_raw_points, n_threads,
                               queue_cap, 0, 131.07f);
}

// Copies the next frame (in file order) into out — float xyz grid or packed
// u8 planes depending on the loader's mode; returns its index, or -1
// when the stream is exhausted.
int loam_loader_next_raw(void* handle, void* out) {
  auto* L = (Loader*)handle;
  std::unique_lock<std::mutex> lk(L->mu);
  for (;;) {
    // search queue for the in-order frame
    if (!L->ready.empty()) {
      // queue is a FIFO of completed frames, possibly out of order; drain
      // matching index by rotating
      size_t qs = L->ready.size();
      for (size_t i = 0; i < qs; i++) {
        auto item = std::move(L->ready.front());
        L->ready.pop();
        if (item.first == L->next_to_emit) {
          std::memcpy(out, item.second.data(), L->frame_bytes);
          L->next_to_emit++;
          L->cv_produce.notify_all();
          return (int)item.first;
        }
        L->ready.push(std::move(item));
      }
    }
    if (L->next_to_emit >= L->paths.size()) return -1;
    bool all_claimed = L->next_to_read >= L->paths.size();
    if (all_claimed && L->ready.empty() && L->workers.empty()) return -1;
    L->cv_produce.notify_all();
    L->cv_consume.wait(lk);
  }
}

int loam_loader_next(void* handle, float* out) {
  return loam_loader_next_raw(handle, out);
}

void loam_loader_destroy(void* handle) {
  auto* L = (Loader*)handle;
  L->stop.store(true);
  L->cv_produce.notify_all();
  L->cv_consume.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

}  // extern "C"
