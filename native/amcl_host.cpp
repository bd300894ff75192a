// Native host-runtime kernels for badger_amcl.
//
// The reference's heavy host-side startup work is C++ (priority-queue
// brushfire EDT over the whole map, occupancy_map.cpp:138-242 and
// octomap.cpp:174-312, logged as "can take some time on large maps").
// This library keeps that work native in the rebuild: the exact
// Felzenszwalb-Huttenlocher separable EDT in cell units, 2D and 3D,
// parallelized over independent rows with std::thread. Python binds via
// ctypes (badger_amcl/utils/native.py); numpy fallbacks exist, so the
// library is a startup-latency optimization, not a correctness dependency.
//
// Build: make -C native   ->  libamcl_host.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <thread>
#include <vector>

namespace {

// Large finite sentinel for "no source" cells. True infinity would produce
// inf - inf = NaN in the parabola-intersection formula and poison the lower
// envelope; a finite sentinel keeps the arithmetic well-defined (matches the
// numpy implementation in badger_amcl/maps/edt.py).
constexpr double kNoSource = 1e18;
constexpr double kInf = std::numeric_limits<double>::infinity();

// 1-D squared-distance lower envelope (Felzenszwalb & Huttenlocher).
// f: n input costs; d: n outputs; v/z: scratch of size n / n+1.
void edt1d(const double* f, double* d, int* v, double* z, int64_t n) {
  int64_t k = 0;
  v[0] = 0;
  z[0] = -kInf;
  z[1] = kInf;
  for (int64_t q = 1; q < n; q++) {
    double s;
    for (;;) {
      const int64_t vk = v[k];
      s = ((f[q] + double(q) * q) - (f[vk] + double(vk) * vk)) /
          (2.0 * q - 2.0 * vk);
      if (s <= z[k] && k > 0) {
        k--;
      } else {
        break;
      }
    }
    k++;
    v[k] = int(q);
    z[k] = s;
    z[k + 1] = kInf;
  }
  k = 0;
  for (int64_t q = 0; q < n; q++) {
    while (z[k + 1] < double(q)) k++;
    const int64_t vk = v[k];
    d[q] = double(q - vk) * (q - vk) + f[vk];
  }
}

// Run edt1d over `rows` rows of length `n` with stride `row_stride`
// (elements within a row are `elem_stride` apart), multithreaded.
void edt_axis(double* data, int64_t rows, int64_t n, int64_t row_stride,
              int64_t elem_stride) {
  const unsigned hw = std::max(1u, std::thread::hardware_concurrency());
  const unsigned n_threads = unsigned(std::min<int64_t>(hw, rows));
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (unsigned t = 0; t < n_threads; t++) {
    threads.emplace_back([=]() {
      std::vector<double> f(n), d(n), z(n + 1);
      std::vector<int> v(n);
      for (int64_t r = t; r < rows; r += n_threads) {
        double* base = data + r * row_stride;
        if (elem_stride == 1) {
          edt1d(base, d.data(), v.data(), z.data(), n);
          std::memcpy(base, d.data(), sizeof(double) * n);
        } else {
          for (int64_t i = 0; i < n; i++) f[i] = base[i * elem_stride];
          edt1d(f.data(), d.data(), v.data(), z.data(), n);
          for (int64_t i = 0; i < n; i++) base[i * elem_stride] = d[i];
        }
      }
    });
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// occupied: uint8 (h, w) row-major; out: double (h, w) — Euclidean distance
// in cell units to the nearest occupied cell (inf if none).
void amcl_edt_2d(const uint8_t* occupied, int64_t h, int64_t w, double* out) {
  const int64_t n = h * w;
  for (int64_t i = 0; i < n; i++) out[i] = occupied[i] ? 0.0 : kNoSource;
  edt_axis(out, h, w, w, 1);      // along columns (within each row)
  edt_axis(out, w, h, 1, w);      // along rows (within each column)
  for (int64_t i = 0; i < n; i++) out[i] = std::sqrt(out[i]);
}

// occupied: uint8 (a, b, c) row-major; out: double (a, b, c).
void amcl_edt_3d(const uint8_t* occupied, int64_t a, int64_t b, int64_t c,
                 double* out) {
  const int64_t n = a * b * c;
  for (int64_t i = 0; i < n; i++) out[i] = occupied[i] ? 0.0 : kNoSource;
  edt_axis(out, a * b, c, c, 1);  // along the last axis
  // along the middle axis: rows are (a * c) fibers with stride c
  {
    const unsigned hw = std::max(1u, std::thread::hardware_concurrency());
    const int64_t fibers = a * c;
    const unsigned n_threads = unsigned(std::min<int64_t>(hw, fibers));
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < n_threads; t++) {
      threads.emplace_back([=]() {
        std::vector<double> f(b), d(b), z(b + 1);
        std::vector<int> v(b);
        for (int64_t fi = t; fi < fibers; fi += n_threads) {
          const int64_t ai = fi / c, ci = fi % c;
          double* base = out + ai * b * c + ci;
          for (int64_t i = 0; i < b; i++) f[i] = base[i * c];
          edt1d(f.data(), d.data(), v.data(), z.data(), b);
          for (int64_t i = 0; i < b; i++) base[i * c] = d[i];
        }
      });
    }
    for (auto& th : threads) th.join();
  }
  edt_axis(out, b * c, a, 1, b * c);  // along the first axis
  for (int64_t i = 0; i < n; i++) out[i] = std::sqrt(out[i]);
}

}  // extern "C"
