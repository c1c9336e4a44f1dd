// zvdb-tpu native host runtime: dataset loading + exact-kNN oracle.
//
// Equivalent of the reference's native (Zig) host code paths
// (SURVEY.md §2.2): the device compute path is JAX/XLA/Pallas; the host-side
// runtime pieces — bulk dataset parsing and the CPU brute-force ground-truth
// oracle used by the recall harness — are C++ for throughput, exposed via a
// plain C ABI consumed with ctypes (no pybind11 in this environment).
//
// Build: make -C native   (produces libzvdb_host.so)

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <queue>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

// ---------------------------------------------------------------------------
// TEXMEX .fvecs/.ivecs parsing: records of [int32 dim][dim * 4-byte elems].
// mmap + parallel copy into a caller-provided contiguous [n, dim] buffer.
// Returns rows copied, or -1 on error. If out == nullptr, just probes and
// writes (n, dim) to out_n/out_dim.
int64_t zvdb_read_vecs(const char* path, float* out, int64_t max_rows,
                       int64_t* out_n, int64_t* out_dim) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return -1; }
  size_t sz = (size_t)st.st_size;
  if (sz < 4) { close(fd); return -1; }
  void* m = mmap(nullptr, sz, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (m == MAP_FAILED) return -1;
  const char* base = (const char*)m;
  int32_t dim;
  memcpy(&dim, base, 4);
  if (dim <= 0 || dim > (1 << 20)) { munmap(m, sz); return -1; }
  size_t rec = 4 + (size_t)dim * 4;
  int64_t n = (int64_t)(sz / rec);
  if (max_rows > 0 && max_rows < n) n = max_rows;
  if (out_n) *out_n = n;
  if (out_dim) *out_dim = dim;
  if (!out) { munmap(m, sz); return n; }

  unsigned hw = std::thread::hardware_concurrency();
  int nthreads = (int)std::min<int64_t>(hw ? hw : 4, std::max<int64_t>(n, 1));
  std::vector<std::thread> ts;
  int64_t chunk = (n + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; t++) {
    ts.emplace_back([=]() {
      int64_t lo = t * chunk, hi = std::min<int64_t>(n, lo + chunk);
      for (int64_t r = lo; r < hi; r++) {
        memcpy(out + r * dim, base + (size_t)r * rec + 4, (size_t)dim * 4);
      }
    });
  }
  for (auto& th : ts) th.join();
  munmap(m, sz);
  return n;
}

// ---------------------------------------------------------------------------
// Exact kNN oracle: multithreaded blocked scan. metric: 0 = squared-L2
// (reference distance contract, src/hnsw.zig:182-192), 1 = negated dot.
// x: [n, d] row-major, q: [nq, d]; writes ids [nq, k] and scores [nq, k]
// (ascending surrogate = squared distance or -dot).
void zvdb_exact_knn(const float* x, int64_t n, const float* q, int64_t nq,
                    int64_t d, int64_t k, int metric, int32_t* out_ids,
                    float* out_scores) {
  if (k > n) k = n;
  std::vector<float> xnorm;
  if (metric == 0) {
    xnorm.resize((size_t)n);
    for (int64_t i = 0; i < n; i++) {
      const float* xi = x + i * d;
      float s = 0.f;
      for (int64_t j = 0; j < d; j++) s += xi[j] * xi[j];
      xnorm[(size_t)i] = s;
    }
  }
  unsigned hw = std::thread::hardware_concurrency();
  int nthreads = (int)std::min<int64_t>(hw ? hw : 4, std::max<int64_t>(nq, 1));
  std::vector<std::thread> ts;
  int64_t chunk = (nq + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; t++) {
    ts.emplace_back([=, &xnorm]() {
      int64_t lo = t * chunk, hi = std::min<int64_t>(nq, lo + chunk);
      std::vector<std::pair<float, int32_t>> heap;  // max-heap of k best
      for (int64_t qi = lo; qi < hi; qi++) {
        const float* qv = q + qi * d;
        heap.clear();
        for (int64_t i = 0; i < n; i++) {
          const float* xi = x + i * d;
          float dot = 0.f;
          for (int64_t j = 0; j < d; j++) dot += qv[j] * xi[j];
          float s = (metric == 0) ? (xnorm[(size_t)i] - 2.f * dot) : -dot;
          if ((int64_t)heap.size() < k) {
            heap.emplace_back(s, (int32_t)i);
            std::push_heap(heap.begin(), heap.end());
          } else if (s < heap.front().first) {
            std::pop_heap(heap.begin(), heap.end());
            heap.back() = {s, (int32_t)i};
            std::push_heap(heap.begin(), heap.end());
          }
        }
        std::sort_heap(heap.begin(), heap.end());
        float qn = 0.f;
        if (metric == 0)
          for (int64_t j = 0; j < d; j++) qn += qv[j] * qv[j];
        for (int64_t r = 0; r < k; r++) {
          out_ids[qi * k + r] = heap[(size_t)r].second;
          out_scores[qi * k + r] = heap[(size_t)r].first + (metric == 0 ? qn : 0.f);
        }
      }
    });
  }
  for (auto& th : ts) th.join();
}

}  // extern "C"
