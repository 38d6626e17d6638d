// Native host-side Criteo DAC TSV parser (the port's own copy of the JAX
// package's torecsys_tpu/data/native/criteo_parser.cc, same entry point and
// same semantics).
//
// Format: Criteo DAC, per line, tab-separated:
//   label \t I1..I13 (decimal ints, may be empty) \t C1..C26 (tokens, may
//   be empty) \n
// Output: fixed-shape row-major buffers:
//   labels  float32 (rows)
//   dense   float32 (rows, 13)    log1p(x) for x > 0, else 0; a token that
//                                 is not [+-]?[0-9]+ counts as missing (0)
//   cats    int32   (rows, 26)    FNV-1a hash of the raw token bytes modulo
//                                 hash_sizes[f]; missing -> 0
// A malformed line (not exactly 40 fields) gives an all-zero row.
//
// The FNV-1a hash and the dense grammar are replicated by the Python
// fallback in torecsys_tpu_torch/data/native/__init__.py (_parse_python).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kDense = 13;
constexpr int kCats = 26;

inline uint32_t fnv1a(const char* s, long n) {
  uint32_t h = 2166136261u;
  for (long i = 0; i < n; ++i) {
    h ^= static_cast<uint8_t>(s[i]);
    h *= 16777619u;
  }
  return h;
}

// Parse one line in [p, end). Returns true if a row was produced.
bool parse_line(const char* p, const char* end, float* label, float* dense,
                int32_t* cats, const int64_t* hash_sizes) {
  if (p >= end) return false;
  // label
  const char* tab = static_cast<const char*>(memchr(p, '\t', end - p));
  if (tab == nullptr) return false;
  *label = (p < tab && *p == '1') ? 1.0f : 0.0f;
  p = tab + 1;
  // 13 dense integer features. Strict token grammar [+-]?[0-9]+ (mirrors
  // _parse_dense_token in __init__.py); anything else counts as missing.
  for (int f = 0; f < kDense; ++f) {
    tab = static_cast<const char*>(memchr(p, '\t', end - p));
    if (tab == nullptr) return false;
    const char* q = p;
    bool neg = false;
    if (q < tab && (*q == '+' || *q == '-')) {
      neg = (*q == '-');
      ++q;
    }
    bool ok = q < tab;  // at least one digit required
    long v = 0;
    for (; q < tab; ++q) {
      if (*q < '0' || *q > '9') {
        ok = false;
        break;
      }
      v = v * 10 + (*q - '0');
    }
    if (!ok) {
      dense[f] = 0.0f;
    } else {
      if (neg) v = -v;
      dense[f] = v > 0 ? log1pf(static_cast<float>(v)) : 0.0f;
    }
    p = tab + 1;
  }
  // 26 categorical hex tokens. The last token must reach end-of-line with no
  // further tab — a >40-field row is malformed (→ zero row), matching the
  // Python oracle's exact `len(parts) == 40` check.
  for (int f = 0; f < kCats; ++f) {
    const char* stop = static_cast<const char*>(memchr(p, '\t', end - p));
    if (f == kCats - 1) {
      if (stop != nullptr) return false;  // extra fields → malformed
      stop = end;
    } else if (stop == nullptr) {
      return false;  // too few fields → malformed
    }
    if (p == stop) {
      cats[f] = 0;
    } else {
      cats[f] = static_cast<int32_t>(fnv1a(p, stop - p) %
                                     static_cast<uint64_t>(hash_sizes[f]));
    }
    p = stop + 1;
  }
  return true;
}

}  // namespace

extern "C" {

// Parses up to max_rows lines of buf[0:len]. Returns the number of rows
// written. Thread-parallel over line ranges; row order matches line order.
int64_t trs_parse_criteo(const char* buf, int64_t len, int64_t max_rows,
                         float* labels, float* dense, int32_t* cats,
                         const int64_t* hash_sizes, int32_t num_threads) {
  // pass 1: line start offsets (serial memchr sweep — ~GB/s, not the
  // bottleneck; keeps row numbering deterministic for pass 2)
  std::vector<int64_t> starts;
  starts.reserve(max_rows + 1);
  int64_t pos = 0;
  while (pos < len && static_cast<int64_t>(starts.size()) < max_rows) {
    starts.push_back(pos);
    const char* nl =
        static_cast<const char*>(memchr(buf + pos, '\n', len - pos));
    pos = (nl == nullptr) ? len : (nl - buf) + 1;
  }
  const int64_t rows = static_cast<int64_t>(starts.size());
  starts.push_back(pos);

  if (num_threads < 1) num_threads = 1;
  if (num_threads > rows) num_threads = rows > 0 ? static_cast<int32_t>(rows) : 1;

  auto work = [&](int64_t r0, int64_t r1) {
    for (int64_t r = r0; r < r1; ++r) {
      const char* p = buf + starts[r];
      const char* line_end = buf + starts[r + 1];
      // strip trailing newline / CR
      while (line_end > p && (line_end[-1] == '\n' || line_end[-1] == '\r'))
        --line_end;
      if (!parse_line(p, line_end, labels + r, dense + r * kDense,
                      cats + r * kCats, hash_sizes)) {
        labels[r] = 0.0f;
        memset(dense + r * kDense, 0, kDense * sizeof(float));
        memset(cats + r * kCats, 0, kCats * sizeof(int32_t));
      }
    }
  };

  if (num_threads == 1) {
    work(0, rows);
  } else {
    std::vector<std::thread> pool;
    const int64_t chunk = (rows + num_threads - 1) / num_threads;
    for (int32_t t = 0; t < num_threads; ++t) {
      const int64_t r0 = t * chunk;
      const int64_t r1 = std::min<int64_t>(rows, r0 + chunk);
      if (r0 >= r1) break;
      pool.emplace_back(work, r0, r1);
    }
    for (auto& th : pool) th.join();
  }
  return rows;
}

}  // extern "C"
