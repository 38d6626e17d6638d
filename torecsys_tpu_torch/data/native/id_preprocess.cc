// Host-side id-stream preprocessing for the trusted presorted sparse route.
//
// The port's own copy of torecsys_tpu/data/native/id_preprocess.cc
// (trs_presort_ids): per batch, the sparse update needs the fused id stream
// sorted, plus its segment structure (torecsys_tpu_torch/ops/sparse.py,
// update_from_host_aux).  The host holds the ids before the step, so it
// computes that here, in prefetch worker threads, while the card runs
// earlier steps.  numpy's stable argsort holds the interpreter lock for the
// whole sort; this function runs with it released (ctypes), so a few worker
// threads presort in parallel.
//
// Algorithm: LSD radix sort (11-bit digits) of (id << 32 | position) packed
// u64 keys, which is stable by construction (equal ids keep their position
// order, as numpy's stable argsort does), then one linear pass that emits
// the sort order, the in-stored-row slot, the stored-row segment index, the
// compact unique stored-row ids (sentinel-padded) and the unique count.
//
// The caller (torecsys_tpu_torch/data/presort.py) has checked every fused
// id against [0, num_rows) in int64 and num_rows against int32 before it
// calls: an id here is never negative and its sum never overflows.

#include <cstddef>
#include <cstdint>
#include <utility>
#include <vector>

namespace {

constexpr int kDigitBits = 11;
constexpr int kBuckets = 1 << kDigitBits;

// Radix-sorts m packed (id << 32 | pos) keys by the id bits, ping-ponging
// between a and b; returns the buffer that holds the sorted keys.  One
// counting pass takes every digit's histogram.
uint64_t* radix_sort_ids(uint64_t* a, uint64_t* b, int64_t m, uint32_t max_id) {
  int bits = 1;
  while ((uint64_t{1} << bits) <= max_id && bits < 32) ++bits;
  const int passes = (bits + kDigitBits - 1) / kDigitBits;
  std::vector<int64_t> counts(static_cast<size_t>(passes) * kBuckets, 0);
  for (int64_t i = 0; i < m; ++i) {
    const uint32_t id = static_cast<uint32_t>(a[i] >> 32);
    for (int p = 0; p < passes; ++p) {
      ++counts[p * kBuckets + ((id >> (p * kDigitBits)) & (kBuckets - 1))];
    }
  }
  for (int p = 0; p < passes; ++p) {
    int64_t* c = counts.data() + p * kBuckets;
    int64_t sum = 0;
    for (int d = 0; d < kBuckets; ++d) {
      const int64_t n = c[d];
      c[d] = sum;
      sum += n;
    }
    const int shift = 32 + p * kDigitBits;  // the id lives in the high 32 bits
    for (int64_t i = 0; i < m; ++i) b[c[(a[i] >> shift) & (kBuckets - 1)]++] = a[i];
    std::swap(a, b);
  }
  return a;
}

}  // namespace

extern "C" {

// Preprocess one batch's fused id stream for the trusted presorted route.
//
//   cats:     (m,) int32 raw slot values, C-order flattened (b * k + slot)
//   slot_off: (k,) int32 per-slot offsets (position i gets slot_off[i % k])
//   order:    out (m,) int32, the permutation into ascending-id order
//   lo:       out (m,) int32, id % pack per sorted position
//   seg:      out (m,) int32, the stored-row segment index per sorted position
//   uids:     out (m,) int32, compact ascending unique stored-row ids,
//             padded with num_stored
//
// Returns the unique stored-row count, or -1 on bad arguments.  The keys
// live in a per-thread scratch buffer that grows and is kept, so a worker
// thread's later batches neither allocate nor fault pages in; the slot loop
// is nested, with no division per id, and a power-of-two pack (every
// P = 128 / E with E a power of two) splits ids by a shift.
int32_t trs_presort_ids(const int32_t* cats, int64_t m, int32_t k, const int32_t* slot_off,
                        int32_t pack, int32_t num_stored, int32_t* order, int32_t* lo,
                        int32_t* seg, int32_t* uids) {
  if (m <= 0 || k <= 0 || pack <= 0 || num_stored <= 0 || m % k != 0) return -1;
  thread_local std::vector<uint64_t> scratch;
  if (static_cast<int64_t>(scratch.size()) < 2 * m) scratch.resize(2 * m);
  uint64_t* a = scratch.data();
  uint32_t max_id = 0;
  for (int64_t i = 0; i < m;) {
    for (int32_t s = 0; s < k; ++s, ++i) {
      const uint32_t id = static_cast<uint32_t>(cats[i] + slot_off[s]);
      if (id > max_id) max_id = id;
      a[i] = (static_cast<uint64_t>(id) << 32) | static_cast<uint32_t>(i);
    }
  }
  a = radix_sort_ids(a, a + m, m, max_id);

  const bool pow2 = (pack & (pack - 1)) == 0;
  const int pack_shift = __builtin_ctz(static_cast<unsigned>(pack));
  int32_t n_unique = 0;
  int32_t prev_hi = -1;
  for (int64_t i = 0; i < m; ++i) {
    const int32_t id = static_cast<int32_t>(a[i] >> 32);
    order[i] = static_cast<int32_t>(a[i] & 0xFFFFFFFFu);
    const int32_t hi = pow2 ? id >> pack_shift : id / pack;
    lo[i] = id - hi * pack;
    if (hi != prev_hi) {
      uids[n_unique++] = hi;
      prev_hi = hi;
    }
    seg[i] = n_unique - 1;
  }
  for (int64_t i = n_unique; i < m; ++i) uids[i] = num_stored;
  return n_unique;
}

}  // extern "C"
