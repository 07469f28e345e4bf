// SA-IS suffix array construction (induced sorting), O(n) time.
//
// This is the native host-side index-construction core of tpufm: the
// framework's equivalent of the reference's vendored
// libdivsufsort-64 (reference resources/divsufsort.c, resources/div-tools/),
// which is only used by the index builder (reference src/genFMindex.c:482).
// We implement SA-IS (Nong, Zhang & Chan 2009) from scratch instead of the
// divsufsort two-stage algorithm: simpler, linear-time, and the builder
// derives every k-BWT directly from the full suffix array with vectorized
// gathers (see tpufm/index/builder.py) instead of the reference's serial
// LF-mapping walk (reference src/genFMindex.c:327-400).
//
// The index type is templated and chosen per call by text length:
// int32 for n+1 <= 2^31-2, uint32 up to 2^32-2 (a full 4 Gbase genome),
// int64 beyond. The induce scans — the hot loops — are memory-latency
// bound (one potential cache miss per element on the random bucket
// writes), so halving the element size roughly doubles the entries per
// cache line on both the sequential read side and the per-bucket write
// streams.
// This stands in for the reference's OpenMP-parallel sssort
// (resources/divsufsort.c:95-123) single-threaded; the parallel build
// path is the on-device builder (tpufm/index/builder_device.py).
//
// Exposed C ABI (used from Python via ctypes):
//   int tpufm_sais_u8(const uint8_t* text, int64_t n, int64_t* sa)
//     Computes the suffix array of text[0..n-1] + an implicit sentinel that
//     compares smaller than every symbol. sa must hold n+1 entries; on
//     return sa[0] == n (the sentinel suffix) and sa[1..n] are the text
//     suffixes in lexicographic order. Returns 0 on success.
//
// Build: g++ -O3 -fPIC -shared -o libtpufm_sais.so sais.cpp

#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

// bkt[c] = start (end=false) or one-past-end (end=true) of bucket for symbol c.
template <typename I>
void get_buckets(const std::vector<I>& cnt, std::vector<I>& bkt, bool end) {
  I sum = 0;
  for (size_t c = 0; c < cnt.size(); ++c) {
    sum += cnt[c];
    bkt[c] = end ? sum : sum - cnt[c];
  }
}

// Core SA-IS over an integer string s[0..n-1] with symbols in [0, K) where
// s[n-1] is the unique smallest symbol (the sentinel). I may be unsigned:
// the empty-slot marker is max(I), not -1, and every loop is underflow-safe.
template <typename I, typename T>
void sais_rec(const T* s, I* SA, I n, I K) {
  const I EMPTY = std::numeric_limits<I>::max();
  if (n == 1) {
    SA[0] = 0;
    return;
  }
  if (n == 2) {
    SA[0] = 1;
    SA[1] = 0;
    return;
  }

  // Classify suffixes: S-type (true) or L-type (false).
  std::vector<bool> stype(n);
  stype[n - 1] = true;
  for (I i = n - 1; i-- > 0;)
    stype[i] = s[i] < s[i + 1] || (s[i] == s[i + 1] && stype[i + 1]);
  auto is_lms = [&](I i) { return i > 0 && stype[i] && !stype[i - 1]; };

  std::vector<I> cnt(K, 0), bkt(K);
  for (I i = 0; i < n; ++i) cnt[s[i]]++;

  auto induce = [&]() {
    // Induce L-type suffixes left-to-right from sorted (LMS or S) positions.
    get_buckets(cnt, bkt, /*end=*/false);
    for (I i = 0; i < n; ++i) {
      I j = SA[i];
      if (j != EMPTY && j > 0 && !stype[j - 1]) SA[bkt[s[j - 1]]++] = j - 1;
    }
    // Induce S-type suffixes right-to-left.
    get_buckets(cnt, bkt, /*end=*/true);
    for (I i = n; i-- > 0;) {
      I j = SA[i];
      if (j != EMPTY && j > 0 && stype[j - 1]) SA[--bkt[s[j - 1]]] = j - 1;
    }
  };

  // Stage 1: approximately sort LMS suffixes by induced sorting.
  std::fill(SA, SA + n, EMPTY);
  get_buckets(cnt, bkt, /*end=*/true);
  for (I i = 1; i < n; ++i)
    if (is_lms(i)) SA[--bkt[s[i]]] = i;
  induce();

  // Stage 2: compact the (now sorted-by-LMS-prefix) LMS positions, then name
  // each LMS substring to build the reduced problem.
  I nlms = 0;
  for (I i = 0; i < n; ++i)
    if (SA[i] != EMPTY && SA[i] > 0 && is_lms(SA[i])) SA[nlms++] = SA[i];

  // Name LMS substrings in SA[0..nlms); store names at SA[nlms + pos/2].
  std::fill(SA + nlms, SA + n, EMPTY);
  I name = 0, prev = EMPTY;
  for (I r = 0; r < nlms; ++r) {
    I pos = SA[r];
    bool differ = false;
    if (prev == EMPTY) {
      differ = true;
    } else {
      // Compare LMS substrings starting at pos and prev (inclusive of the
      // terminating LMS character).
      for (I off = 0;; ++off) {
        I a = pos + off, b = prev + off;
        if (a == n || b == n) { differ = (a != b); break; }
        if (s[a] != s[b] || stype[a] != stype[b]) { differ = true; break; }
        if (off > 0 && (is_lms(a) || is_lms(b))) { differ = !(is_lms(a) && is_lms(b)); break; }
      }
    }
    if (differ) { ++name; prev = pos; }
    SA[nlms + pos / 2] = name - 1;
  }
  // Compact names into s1 (order of appearance in the text).
  std::vector<I> s1(nlms);
  {
    I j = nlms;
    for (I i = n; i-- > nlms;)
      if (SA[i] != EMPTY) s1[--j] = SA[i];
  }

  // Positions of LMS suffixes in text order.
  std::vector<I> lms_pos(nlms);
  {
    I j = 0;
    for (I i = 1; i < n; ++i)
      if (is_lms(i)) lms_pos[j++] = i;
  }

  // Stage 3: sort LMS suffixes exactly.
  if (name < nlms) {
    sais_rec<I, I>(s1.data(), SA, nlms, name);
  } else {
    for (I i = 0; i < nlms; ++i) SA[s1[i]] = i;
  }
  // SA[0..nlms) is now the suffix array of the reduced string; translate to
  // text positions, in sorted order, stored in s1.
  for (I i = 0; i < nlms; ++i) s1[i] = lms_pos[SA[i]];

  // Stage 4: place exactly-sorted LMS suffixes at bucket ends, induce final SA.
  std::fill(SA, SA + n, EMPTY);
  get_buckets(cnt, bkt, /*end=*/true);
  for (I r = nlms; r-- > 0;) {
    I pos = s1[r];
    SA[--bkt[s[pos]]] = pos;
  }
  induce();
}

// Run sais_rec at width I over the sentinel-shifted copy of text, widening
// the result into the caller's int64 buffer.
template <typename I>
void sais_narrow(const std::vector<uint8_t>& t, int64_t n1, int64_t* sa) {
  std::vector<I> sa_narrow(static_cast<size_t>(n1));
  sais_rec<I, uint8_t>(t.data(), sa_narrow.data(), static_cast<I>(n1), 256);
  for (int64_t i = 0; i < n1; ++i) sa[i] = static_cast<int64_t>(sa_narrow[i]);
}

}  // namespace

extern "C" {

// Suffix array of text + implicit smallest sentinel. sa has n+1 slots.
// Returns 0 on success, -1 on bad arguments, -2 on allocation failure,
// -3 if any input byte is 255 (the +1 sentinel shift would wrap it to 0
// and silently collide with the sentinel).
int tpufm_sais_u8(const uint8_t* text, int64_t n, int64_t* sa) {
  if (n < 0 || !sa || (n > 0 && !text)) return -1;
  if (n == 0) {
    sa[0] = 0;
    return 0;
  }
  try {
    // Shift symbols by +1 so 0 is free for the sentinel.
    std::vector<uint8_t> t(static_cast<size_t>(n) + 1);
    for (int64_t i = 0; i < n; ++i) {
      if (text[i] == 255) return -3;
      t[i] = static_cast<uint8_t>(text[i] + 1);
    }
    t[n] = 0;
    const int64_t n1 = n + 1;
    // Narrowest index type that can hold n1 positions plus the EMPTY
    // marker (max(I) must stay distinct from any position).
    if (n1 <= std::numeric_limits<int32_t>::max() - 1) {
      sais_narrow<int32_t>(t, n1, sa);
    } else if (static_cast<uint64_t>(n1) <=
               std::numeric_limits<uint32_t>::max() - 1) {
      sais_narrow<uint32_t>(t, n1, sa);  // 2-4 Gbase genomes
    } else {
      sais_rec<int64_t, uint8_t>(t.data(), sa, n1, 256);
    }
  } catch (const std::bad_alloc&) {
    return -2;  // keep the C ABI contract: no exception crosses ctypes
  }
  return 0;
}

}  // extern "C"
