// mulls_io: native point-cloud IO + prefetch runtime for mulls_tpu_torch,
// a copy of mulls_tpu/native/src/mulls_io.cpp (the port keeps its own).
//
// Counterpart of the reference's C++ DataIo layer
// (reference: include/common/dataio.hpp:147-446 read_cloud_file dispatch,
// :357-379 KITTI bin, :279-313 pcd) plus the prefetch ring the reference
// never needed (it was synchronous and CPU-only).  Readers decode scans
// into FIXED-SHAPE padded buffers on a worker-thread pool so the Python
// Python loop never blocks on disk: while frame i computes on the card,
// frames i+1..i+depth are being decoded into the ring.
//
// C ABI (consumed via ctypes from mulls_tpu_torch/io/native.py):
//   mio_read_cloud(path, n_raw, seed, xyz, intensity, ts, mask) -> n or <0
//   mio_prefetch_create(paths, n_files, n_raw, workers, depth) -> handle
//   mio_prefetch_next(handle, xyz, intensity, ts, mask) -> n or <0
//   mio_prefetch_destroy(handle)
//   mio_packed_prefetch_{create,next,destroy}: whole segments already
//   quantized to the packed wire format (core/cloud.py::pack_raw_host)
//
// Built at first use by mulls_tpu_torch/io/native.py::build_library
// (g++ -O3 -std=c++17 -fPIC -pthread -shared) into
// build/mulls_tpu_torch_native/<source hash>/libmulls_io.so.

#include <algorithm>
#include <atomic>
#include <cctype>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Cloud {
  std::vector<float> xyz;        // n*3
  std::vector<float> intensity;  // n
};

bool ends_with(const std::string &s, const char *suf) {
  size_t n = strlen(suf);
  if (s.size() < n) return false;
  for (size_t i = 0; i < n; ++i)
    if (std::tolower(s[s.size() - n + i]) != suf[i]) return false;
  return true;
}

// ---- KITTI .bin: packed float32 x,y,z,intensity (dataio.hpp:357-379) ----
int read_bin(const std::string &path, Cloud &out) {
  FILE *f = std::fopen(path.c_str(), "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long bytes = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  long n = bytes / (4 * sizeof(float));
  std::vector<float> buf(n * 4);
  size_t got = std::fread(buf.data(), sizeof(float), n * 4, f);
  std::fclose(f);
  if (got != static_cast<size_t>(n * 4)) return -2;
  out.xyz.resize(n * 3);
  out.intensity.resize(n);
  for (long i = 0; i < n; ++i) {
    out.xyz[i * 3 + 0] = buf[i * 4 + 0];
    out.xyz[i * 3 + 1] = buf[i * 4 + 1];
    out.xyz[i * 3 + 2] = buf[i * 4 + 2];
    // x255 as io/kitti.py::read_kitti_bin reads it, so that both of the
    // port's readers give the same clouds (the reference's copy of this
    // source keeps the file's value)
    out.intensity[i] = buf[i * 4 + 3] * 255.0f;
  }
  return static_cast<int>(n);
}

// ---- PCD v0.7, binary or ascii, f32/f64 scalar fields ----
struct PcdField {
  std::string name;
  int size = 4;
  char type = 'F';
  int count = 1;
};

int read_pcd(const std::string &path, Cloud &out) {
  FILE *f = std::fopen(path.c_str(), "rb");
  if (!f) return -1;
  char line[4096];
  std::vector<PcdField> fields;
  long n = 0;
  std::string mode;
  while (std::fgets(line, sizeof(line), f)) {
    std::string s(line);
    while (!s.empty() && (s.back() == '\n' || s.back() == '\r')) s.pop_back();
    if (s.empty() || s[0] == '#') continue;
    size_t sp = s.find(' ');
    std::string key = s.substr(0, sp);
    std::string rest = sp == std::string::npos ? "" : s.substr(sp + 1);
    auto split = [](const std::string &r) {
      std::vector<std::string> v;
      size_t i = 0;
      while (i < r.size()) {
        size_t j = r.find(' ', i);
        if (j == std::string::npos) j = r.size();
        if (j > i) v.push_back(r.substr(i, j - i));
        i = j + 1;
      }
      return v;
    };
    if (key == "FIELDS") {
      for (auto &nm : split(rest)) fields.push_back({nm, 4, 'F', 1});
    } else if (key == "SIZE") {
      auto v = split(rest);
      for (size_t i = 0; i < v.size() && i < fields.size(); ++i)
        fields[i].size = std::stoi(v[i]);
    } else if (key == "TYPE") {
      auto v = split(rest);
      for (size_t i = 0; i < v.size() && i < fields.size(); ++i)
        fields[i].type = v[i][0];
    } else if (key == "COUNT") {
      auto v = split(rest);
      for (size_t i = 0; i < v.size() && i < fields.size(); ++i)
        fields[i].count = std::stoi(v[i]);
    } else if (key == "POINTS") {
      n = std::stol(rest);
    } else if (key == "WIDTH" && n == 0) {
      n = std::stol(rest);
    } else if (key == "DATA") {
      mode = rest;
      break;
    }
  }
  int stride = 0, off_x = -1, off_y = -1, off_z = -1, off_i = -1;
  int col = 0, col_x = -1, col_y = -1, col_z = -1, col_i = -1, ncols = 0;
  std::vector<char> ftype_at_off;
  for (auto &fd : fields) {
    for (int c = 0; c < fd.count; ++c) {
      if (fd.name == "x") { off_x = stride; col_x = col; }
      if (fd.name == "y") { off_y = stride; col_y = col; }
      if (fd.name == "z") { off_z = stride; col_z = col; }
      if (fd.name == "intensity") { off_i = stride; col_i = col; }
      stride += fd.size;
      ++col;
    }
  }
  ncols = col;
  if (off_x < 0 || off_y < 0 || off_z < 0 || n <= 0) {
    std::fclose(f);
    return -3;
  }
  out.xyz.resize(n * 3);
  out.intensity.assign(n, 0.0f);
  // precompute field width at each byte offset (the inner loop must not
  // scan the field list per point)
  std::vector<int> size_at(stride + 1, 4);
  {
    int s = 0;
    for (auto &fd : fields)
      for (int c = 0; c < fd.count; ++c) {
        if (s <= stride) size_at[s] = fd.size;
        s += fd.size;
      }
  }
  if (mode == "binary") {
    bool x8 = size_at[off_x] == 8, y8 = size_at[off_y] == 8,
         z8 = size_at[off_z] == 8,
         i8 = off_i >= 0 && size_at[off_i] == 8;
    auto getf = [](const char *p, bool wide) -> float {
      if (wide) {
        double d;
        std::memcpy(&d, p, 8);
        return static_cast<float>(d);
      }
      float v;
      std::memcpy(&v, p, 4);
      return v;
    };
    std::vector<char> all(static_cast<size_t>(n) * stride);
    size_t got = std::fread(all.data(), 1, all.size(), f);
    long nn = static_cast<long>(got / stride);
    if (nn < n) n = nn;
    for (long i = 0; i < n; ++i) {
      const char *p = all.data() + static_cast<size_t>(i) * stride;
      out.xyz[i * 3 + 0] = getf(p + off_x, x8);
      out.xyz[i * 3 + 1] = getf(p + off_y, y8);
      out.xyz[i * 3 + 2] = getf(p + off_z, z8);
      if (off_i >= 0) out.intensity[i] = getf(p + off_i, i8);
    }
  } else {  // ascii
    for (long i = 0; i < n; ++i) {
      if (!std::fgets(line, sizeof(line), f)) { n = i; break; }
      std::vector<double> vals;
      char *p = line;
      while (*p && vals.size() < static_cast<size_t>(ncols)) {
        char *end;
        double v = std::strtod(p, &end);
        if (end == p) break;
        vals.push_back(v);
        p = end;
      }
      if (static_cast<int>(vals.size()) <= col_z) { n = i; break; }
      out.xyz[i * 3 + 0] = static_cast<float>(vals[col_x]);
      out.xyz[i * 3 + 1] = static_cast<float>(vals[col_y]);
      out.xyz[i * 3 + 2] = static_cast<float>(vals[col_z]);
      if (col_i >= 0 && col_i < static_cast<int>(vals.size()))
        out.intensity[i] = static_cast<float>(vals[col_i]);
    }
  }
  std::fclose(f);
  out.xyz.resize(n * 3);
  out.intensity.resize(n);
  return static_cast<int>(n);
}

// ---- txt / csv / ply(minimal binary_le + ascii, f32 props) ----
int read_txt(const std::string &path, Cloud &out, char delim) {
  FILE *f = std::fopen(path.c_str(), "r");
  if (!f) return -1;
  char line[4096];
  out.xyz.clear();
  out.intensity.clear();
  while (std::fgets(line, sizeof(line), f)) {
    if (delim == ',')
      for (char *p = line; *p; ++p)
        if (*p == ',') *p = ' ';
    char *p = line, *end;
    double v[4] = {0, 0, 0, 0};
    int k = 0;
    while (k < 4) {
      v[k] = std::strtod(p, &end);
      if (end == p) break;
      p = end;
      ++k;
    }
    if (k < 3) continue;
    out.xyz.push_back(static_cast<float>(v[0]));
    out.xyz.push_back(static_cast<float>(v[1]));
    out.xyz.push_back(static_cast<float>(v[2]));
    out.intensity.push_back(k > 3 ? static_cast<float>(v[3]) : 0.0f);
  }
  std::fclose(f);
  return static_cast<int>(out.intensity.size());
}

int read_ply(const std::string &path, Cloud &out) {
  FILE *f = std::fopen(path.c_str(), "rb");
  if (!f) return -1;
  char line[1024];
  long n = 0;
  bool binary = false;
  std::vector<std::string> props;
  while (std::fgets(line, sizeof(line), f)) {
    std::string s(line);
    while (!s.empty() && (s.back() == '\n' || s.back() == '\r')) s.pop_back();
    if (s.rfind("format", 0) == 0) binary = s.find("binary") != std::string::npos;
    else if (s.rfind("element vertex", 0) == 0) n = std::stol(s.substr(15));
    else if (s.rfind("property", 0) == 0 && s.find("list") == std::string::npos)
      props.push_back(s.substr(s.rfind(' ') + 1));
    else if (s == "end_header") break;
  }
  int ix = -1, iy = -1, iz = -1, ii = -1;
  for (size_t i = 0; i < props.size(); ++i) {
    if (props[i] == "x") ix = static_cast<int>(i);
    if (props[i] == "y") iy = static_cast<int>(i);
    if (props[i] == "z") iz = static_cast<int>(i);
    if (props[i] == "intensity") ii = static_cast<int>(i);
  }
  if (ix < 0 || iy < 0 || iz < 0 || n <= 0) { std::fclose(f); return -3; }
  out.xyz.resize(n * 3);
  out.intensity.assign(n, 0.0f);
  int np = static_cast<int>(props.size());
  if (binary) {
    std::vector<float> row(np);
    for (long i = 0; i < n; ++i) {
      if (std::fread(row.data(), 4, np, f) != static_cast<size_t>(np)) {
        n = i;
        break;
      }
      out.xyz[i * 3] = row[ix];
      out.xyz[i * 3 + 1] = row[iy];
      out.xyz[i * 3 + 2] = row[iz];
      if (ii >= 0) out.intensity[i] = row[ii];
    }
  } else {
    for (long i = 0; i < n; ++i) {
      if (!std::fgets(line, sizeof(line), f)) { n = i; break; }
      std::vector<double> vals(np, 0.0);
      char *p = line, *end;
      for (int k = 0; k < np; ++k) {
        vals[k] = std::strtod(p, &end);
        if (end == p) break;
        p = end;
      }
      out.xyz[i * 3] = static_cast<float>(vals[ix]);
      out.xyz[i * 3 + 1] = static_cast<float>(vals[iy]);
      out.xyz[i * 3 + 2] = static_cast<float>(vals[iz]);
      if (ii >= 0) out.intensity[i] = static_cast<float>(vals[ii]);
    }
  }
  std::fclose(f);
  out.xyz.resize(n * 3);
  out.intensity.resize(n);
  return static_cast<int>(n);
}


// ---- LAS 1.2-1.4, point formats 0-10 (x,y,z scaled int32 + intensity) ----
// Plays the reference's libLAS role (`dataio.hpp:393-768`) without the
// dependency: only the fields the pipeline uses are decoded.
int read_las(const std::string &path, Cloud &out) {
  FILE *f = std::fopen(path.c_str(), "rb");
  if (!f) return -1;
  unsigned char hdr[375];
  size_t got = std::fread(hdr, 1, sizeof(hdr), f);
  if (got < 227 || std::memcmp(hdr, "LASF", 4) != 0) {
    std::fclose(f);
    return -3;
  }
  auto u16 = [&](int off) { uint16_t v; std::memcpy(&v, hdr + off, 2); return v; };
  auto u32 = [&](int off) { uint32_t v; std::memcpy(&v, hdr + off, 4); return v; };
  auto u64at = [&](int off) { uint64_t v; std::memcpy(&v, hdr + off, 8); return v; };
  auto f64 = [&](int off) { double v; std::memcpy(&v, hdr + off, 8); return v; };
  uint32_t data_off = u32(96);
  uint16_t rec_len = u16(105);
  uint64_t n = u32(107);
  int vmin = hdr[25];
  if (n == 0 && vmin >= 4 && got >= 255)
    n = u64at(247);  // LAS 1.4 extended count
  double sx = f64(131), sy = f64(139), sz = f64(147);
  double ox = f64(155), oy = f64(163), oz = f64(171);
  if (rec_len < 12 || n == 0) { std::fclose(f); return -3; }
  std::fseek(f, data_off, SEEK_SET);
  out.xyz.resize(n * 3);
  out.intensity.assign(n, 0.0f);
  std::vector<char> rec(rec_len);
  uint64_t i = 0;
  for (; i < n; ++i) {
    if (std::fread(rec.data(), 1, rec_len, f) != rec_len) break;
    int32_t xi, yi, zi;
    std::memcpy(&xi, rec.data(), 4);
    std::memcpy(&yi, rec.data() + 4, 4);
    std::memcpy(&zi, rec.data() + 8, 4);
    out.xyz[i * 3 + 0] = static_cast<float>(xi * sx + ox);
    out.xyz[i * 3 + 1] = static_cast<float>(yi * sy + oy);
    out.xyz[i * 3 + 2] = static_cast<float>(zi * sz + oz);
    if (rec_len >= 14) {
      uint16_t inten;
      std::memcpy(&inten, rec.data() + 12, 2);
      out.intensity[i] = static_cast<float>(inten);
    }
  }
  std::fclose(f);
  out.xyz.resize(i * 3);
  out.intensity.resize(i);
  return static_cast<int>(i);
}

int read_any(const std::string &path, Cloud &out) {
  if (ends_with(path, ".bin")) return read_bin(path, out);
  if (ends_with(path, ".pcd")) return read_pcd(path, out);
  if (ends_with(path, ".ply")) return read_ply(path, out);
  if (ends_with(path, ".las")) return read_las(path, out);
  if (ends_with(path, ".csv")) return read_txt(path, out, ',');
  if (ends_with(path, ".txt") || ends_with(path, ".xyz"))
    return read_txt(path, out, ' ');
  return -4;
}

// Pad/subsample into the fixed-shape contract (parity with
// mulls_tpu_torch.io.dataset.pad_cloud: ordinal ts_ratio, random keep-subset
// when over capacity).
int pad_into(const Cloud &c, int n_raw, uint64_t seed, float *xyz,
             float *intensity, float *ts, uint8_t *mask) {
  long n = static_cast<long>(c.intensity.size());
  std::vector<int32_t> keep;
  if (n > n_raw) {
    keep.resize(n);
    for (long i = 0; i < n; ++i) keep[i] = static_cast<int32_t>(i);
    std::mt19937_64 rng(seed);
    // partial Fisher-Yates: first n_raw entries are a uniform subset
    for (int i = 0; i < n_raw; ++i) {
      std::uniform_int_distribution<long> d(i, n - 1);
      std::swap(keep[i], keep[d(rng)]);
    }
    keep.resize(n_raw);
    std::sort(keep.begin(), keep.end());
  }
  long m = std::min<long>(n, n_raw);
  float denom = static_cast<float>(std::max<long>(n - 1, 1));
  for (long i = 0; i < m; ++i) {
    long s = keep.empty() ? i : keep[i];
    xyz[i * 3 + 0] = c.xyz[s * 3 + 0];
    xyz[i * 3 + 1] = c.xyz[s * 3 + 1];
    xyz[i * 3 + 2] = c.xyz[s * 3 + 2];
    intensity[i] = c.intensity[s];
    ts[i] = static_cast<float>(s) / denom;
    mask[i] = 1;
  }
  for (long i = m; i < n_raw; ++i) {
    xyz[i * 3] = xyz[i * 3 + 1] = xyz[i * 3 + 2] = 0.0f;
    intensity[i] = 0.0f;
    ts[i] = 0.0f;
    mask[i] = 0;
  }
  return static_cast<int>(m);
}

// ---- prefetch pool ----
struct Slot {
  std::vector<float> xyz, intensity, ts;
  std::vector<uint8_t> mask;
  int n = 0;
  bool ready = false;
};

struct Prefetcher {
  std::vector<std::string> paths;
  int n_raw = 0;
  int depth = 0;
  std::vector<Slot> slots;          // ring, slot k holds frame k mod depth
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_ready, cv_free;
  std::atomic<long> next_job{0};
  long next_read = 0;               // next frame index the consumer wants
  long freed_below = 0;             // frames < freed_below may be overwritten
  bool stop = false;

  void worker() {
    Cloud c;
    for (;;) {
      long job = next_job.fetch_add(1);
      if (job >= static_cast<long>(paths.size())) return;
      int n = read_any(paths[job], c);
      Slot tmp;
      tmp.xyz.resize(static_cast<size_t>(n_raw) * 3);
      tmp.intensity.resize(n_raw);
      tmp.ts.resize(n_raw);
      tmp.mask.resize(n_raw);
      tmp.n = n < 0 ? n
                    : pad_into(c, n_raw, 0x9e3779b97f4a7c15ULL ^ job,
                               tmp.xyz.data(), tmp.intensity.data(),
                               tmp.ts.data(), tmp.mask.data());
      std::unique_lock<std::mutex> lk(mu);
      cv_free.wait(lk, [&] { return stop || job < freed_below + depth; });
      if (stop) return;
      Slot &s = slots[job % depth];
      s = std::move(tmp);
      s.ready = true;
      cv_ready.notify_all();
    }
  }

  int next(float *xyz, float *intensity, float *ts, uint8_t *mask) {
    std::unique_lock<std::mutex> lk(mu);
    if (next_read >= static_cast<long>(paths.size())) return -100;
    Slot &s = slots[next_read % depth];
    cv_ready.wait(lk, [&] { return s.ready; });
    int n = s.n;
    if (n >= 0) {
      std::memcpy(xyz, s.xyz.data(), s.xyz.size() * 4);
      std::memcpy(intensity, s.intensity.data(), s.intensity.size() * 4);
      std::memcpy(ts, s.ts.data(), s.ts.size() * 4);
      std::memcpy(mask, s.mask.data(), s.mask.size());
    }
    s.ready = false;
    ++next_read;
    freed_below = next_read;
    cv_free.notify_all();
    return n;
  }
};

}  // namespace

extern "C" {

int mio_read_cloud(const char *path, int n_raw, uint64_t seed, float *xyz,
                   float *intensity, float *ts, uint8_t *mask) {
  Cloud c;
  int n = read_any(path, c);
  if (n < 0) return n;
  return pad_into(c, n_raw, seed, xyz, intensity, ts, mask);
}

void *mio_prefetch_create(const char **paths, int n_files, int n_raw,
                          int workers, int depth) {
  auto *p = new Prefetcher();
  p->paths.assign(paths, paths + n_files);
  p->n_raw = n_raw;
  p->depth = std::max(depth, 2);
  p->slots.resize(p->depth);
  int nw = std::max(1, std::min(workers, 16));
  for (int i = 0; i < nw; ++i)
    p->workers.emplace_back([p] { p->worker(); });
  return p;
}

int mio_prefetch_next(void *handle, float *xyz, float *intensity, float *ts,
                      uint8_t *mask) {
  return static_cast<Prefetcher *>(handle)->next(xyz, intensity, ts, mask);
}

void mio_prefetch_destroy(void *handle) {
  auto *p = static_cast<Prefetcher *>(handle);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->stop = true;
  }
  p->cv_free.notify_all();
  for (auto &t : p->workers) t.join();
  delete p;
}

}  // extern "C"

// ---- packed wire-format emission (quantize while padding) -------------
// Mirrors mulls_tpu_torch.core.cloud.pack_raw_host: int16 xyz at 4 mm, uint8
// intensity, uint16 timestamp ratio, prefix-count validity.

namespace {
constexpr float kXyzScale = 250.0f;

int pad_into_packed(const Cloud &c, int n_raw, uint64_t seed, int16_t *xyz_q,
                    uint8_t *inten_q, uint16_t *ts_q) {
  long n = static_cast<long>(c.intensity.size());
  std::vector<int32_t> keep;
  if (n > n_raw) {
    keep.resize(n);
    for (long i = 0; i < n; ++i) keep[i] = static_cast<int32_t>(i);
    std::mt19937_64 rng(seed);
    for (int i = 0; i < n_raw; ++i) {
      std::uniform_int_distribution<long> d(i, n - 1);
      std::swap(keep[i], keep[d(rng)]);
    }
    keep.resize(n_raw);
    std::sort(keep.begin(), keep.end());
  }
  long m = std::min<long>(n, n_raw);
  float denom = static_cast<float>(std::max<long>(n - 1, 1));
  auto q16 = [](float v) {
    float s = std::nearbyint(v * kXyzScale);
    return static_cast<int16_t>(std::max(-32767.0f, std::min(32767.0f, s)));
  };
  for (long i = 0; i < m; ++i) {
    long s = keep.empty() ? i : keep[i];
    xyz_q[i * 3 + 0] = q16(c.xyz[s * 3 + 0]);
    xyz_q[i * 3 + 1] = q16(c.xyz[s * 3 + 1]);
    xyz_q[i * 3 + 2] = q16(c.xyz[s * 3 + 2]);
    float in255 = std::nearbyint(c.intensity[s] * 255.0f);
    inten_q[i] = static_cast<uint8_t>(std::max(0.0f, std::min(255.0f, in255)));
    float ts = std::nearbyint(static_cast<float>(s) / denom * 65535.0f);
    ts_q[i] = static_cast<uint16_t>(std::max(0.0f, std::min(65535.0f, ts)));
  }
  std::memset(xyz_q + m * 3, 0, (n_raw - m) * 3 * sizeof(int16_t));
  std::memset(inten_q + m, 0, n_raw - m);
  std::memset(ts_q + m, 0, (n_raw - m) * sizeof(uint16_t));
  return static_cast<int>(m);
}

struct PackedPrefetcher {
  std::vector<std::string> paths;
  int n_raw = 0, segment = 0, depth = 0;
  long n_batches = 0;
  struct Batch {
    std::vector<int16_t> xyz;
    std::vector<uint8_t> inten;
    std::vector<uint16_t> ts;
    std::vector<int32_t> counts;
    int frames = 0;
    bool ready = false;
  };
  std::vector<Batch> ring;
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_ready, cv_free;
  std::atomic<long> next_job{0};
  long next_read = 0, freed_below = 0;
  bool stop = false;

  void worker() {
    Cloud c;
    for (;;) {
      long job = next_job.fetch_add(1);
      if (job >= n_batches) return;
      long lo = job * segment;
      long hi = std::min<long>(lo + segment, paths.size());
      Batch tmp;
      size_t per = static_cast<size_t>(n_raw);
      tmp.xyz.resize(static_cast<size_t>(segment) * per * 3);
      tmp.inten.resize(static_cast<size_t>(segment) * per);
      tmp.ts.resize(static_cast<size_t>(segment) * per);
      tmp.counts.assign(segment, 0);
      tmp.frames = static_cast<int>(hi - lo);
      for (long f = lo; f < hi; ++f) {
        int n = read_any(paths[f], c);
        long k = f - lo;
        tmp.counts[k] = n < 0 ? 0
            : pad_into_packed(c, n_raw, 0x9e3779b97f4a7c15ULL ^ f,
                              tmp.xyz.data() + k * per * 3,
                              tmp.inten.data() + k * per,
                              tmp.ts.data() + k * per);
      }
      // tail padding: repeat the last decoded frame so shapes stay static
      for (long k = tmp.frames; k < segment; ++k) {
        long src = tmp.frames - 1;
        std::memcpy(tmp.xyz.data() + k * per * 3,
                    tmp.xyz.data() + src * per * 3,
                    per * 3 * sizeof(int16_t));
        std::memcpy(tmp.inten.data() + k * per, tmp.inten.data() + src * per,
                    per);
        std::memcpy(tmp.ts.data() + k * per, tmp.ts.data() + src * per,
                    per * sizeof(uint16_t));
        tmp.counts[k] = tmp.counts[src];
      }
      std::unique_lock<std::mutex> lk(mu);
      cv_free.wait(lk, [&] { return stop || job < freed_below + depth; });
      if (stop) return;
      Batch &b = ring[job % depth];
      b = std::move(tmp);
      b.ready = true;
      cv_ready.notify_all();
    }
  }

  int next(int16_t *xyz, uint8_t *inten, uint16_t *ts, int32_t *counts) {
    std::unique_lock<std::mutex> lk(mu);
    if (next_read >= n_batches) return -100;
    Batch &b = ring[next_read % depth];
    cv_ready.wait(lk, [&] { return b.ready; });
    std::memcpy(xyz, b.xyz.data(), b.xyz.size() * sizeof(int16_t));
    std::memcpy(inten, b.inten.data(), b.inten.size());
    std::memcpy(ts, b.ts.data(), b.ts.size() * sizeof(uint16_t));
    std::memcpy(counts, b.counts.data(), b.counts.size() * sizeof(int32_t));
    int frames = b.frames;
    b.ready = false;
    ++next_read;
    freed_below = next_read;
    cv_free.notify_all();
    return frames;
  }
};
}  // namespace

extern "C" {

void *mio_packed_prefetch_create(const char **paths, int n_files, int n_raw,
                                 int segment, int workers, int depth) {
  auto *p = new PackedPrefetcher();
  p->paths.assign(paths, paths + n_files);
  p->n_raw = n_raw;
  p->segment = std::max(segment, 1);
  p->depth = std::max(depth, 2);
  p->n_batches = (n_files + p->segment - 1) / p->segment;
  p->ring.resize(p->depth);
  int nw = std::max(1, std::min(workers, 16));
  for (int i = 0; i < nw; ++i)
    p->workers.emplace_back([p] { p->worker(); });
  return p;
}

int mio_packed_prefetch_next(void *handle, int16_t *xyz, uint8_t *inten,
                             uint16_t *ts, int32_t *counts) {
  return static_cast<PackedPrefetcher *>(handle)->next(xyz, inten, ts,
                                                       counts);
}

void mio_packed_prefetch_destroy(void *handle) {
  auto *p = static_cast<PackedPrefetcher *>(handle);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->stop = true;
  }
  p->cv_free.notify_all();
  for (auto &t : p->workers) t.join();
  delete p;
}

}  // extern "C"
