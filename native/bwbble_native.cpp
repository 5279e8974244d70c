// bwbble_tpu native runtime: SA-IS suffix-array construction and FM-index
// occurrence-checkpoint construction.
//
// Fresh implementation of the SA-IS induced-sorting algorithm
// (G. Nong, S. Zhang, W. H. Chan, "Two Efficient Algorithms for Linear Time
// Suffix Array Construction", 2009).  Plays the role of the reference's
// in-RAM suffix sorter (mg-aligner/is.c) for index construction, plus the
// host gold engine and D-bound scanner that the device pipeline falls back
// to and overlaps with device work.
//
// Exposed via a C ABI for ctypes (see bwbble_tpu/native.py).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>
#if defined(__x86_64__) || defined(_M_X64)
#include <immintrin.h>
#endif

namespace {

// Core SA-IS over an integer string whose last character is the unique
// smallest symbol (a sentinel).  SA receives the full suffix array.
template <typename I>
void sais_core(const I* s, I* SA, I n, I K) {
  if (n == 1) {
    SA[0] = 0;
    return;
  }
  const I EMPTY = static_cast<I>(-1);

  // Suffix types: 1 = S-type (suffix smaller than its right neighbor).
  std::vector<uint8_t> st(n);
  st[n - 1] = 1;
  for (I i = n - 2; i >= 0; --i)
    st[i] = (s[i] < s[i + 1] || (s[i] == s[i + 1] && st[i + 1])) ? 1 : 0;
  auto is_lms = [&](I i) { return i > 0 && st[i] && !st[i - 1]; };

  std::vector<I> bkt(K);
  auto fill_buckets = [&](bool ends) {
    std::fill(bkt.begin(), bkt.end(), I(0));
    for (I i = 0; i < n; ++i) bkt[s[i]]++;
    I sum = 0;
    for (I k = 0; k < K; ++k) {
      sum += bkt[k];
      bkt[k] = ends ? sum : sum - bkt[k];
    }
  };

  auto induce = [&]() {
    // induce L-type from bucket heads (left to right)
    fill_buckets(false);
    for (I i = 0; i < n; ++i) {
      I j = SA[i];
      if (j != EMPTY && j > 0 && !st[j - 1]) SA[bkt[s[j - 1]]++] = j - 1;
    }
    // induce S-type from bucket ends (right to left)
    fill_buckets(true);
    for (I i = n - 1; i >= 0; --i) {
      I j = SA[i];
      if (j != EMPTY && j > 0 && st[j - 1]) SA[--bkt[s[j - 1]]] = j - 1;
    }
  };

  // Stage 1: sort LMS substrings by one induced pass.
  std::fill(SA, SA + n, EMPTY);
  fill_buckets(true);
  for (I i = 1; i < n; ++i)
    if (is_lms(i)) SA[--bkt[s[i]]] = i;
  induce();

  // Compact the (now sorted) LMS positions to the front.
  I n1 = 0;
  for (I i = 0; i < n; ++i)
    if (is_lms(SA[i])) SA[n1++] = SA[i];

  // Stage 2: name LMS substrings to build the reduced problem.
  std::fill(SA + n1, SA + n, EMPTY);
  I name = 0, prev = EMPTY;
  for (I i = 0; i < n1; ++i) {
    I pos = SA[i];
    bool differs = (prev == EMPTY);
    if (!differs) {
      for (I d = 0;; ++d) {
        if (s[pos + d] != s[prev + d] || st[pos + d] != st[prev + d]) {
          differs = true;
          break;
        }
        if (d > 0 && (is_lms(pos + d) || is_lms(prev + d))) break;
      }
    }
    if (differs) {
      ++name;
      prev = pos;
    }
    SA[n1 + pos / 2] = name - 1;
  }
  for (I i = n - 1, j = n - 1; i >= n1; --i)
    if (SA[i] != EMPTY) SA[j--] = SA[i];

  // Stage 3: solve the reduced problem (recurse only if names repeat).
  I* SA1 = SA;
  I* s1 = SA + n - n1;
  if (name < n1) {
    sais_core<I>(s1, SA1, n1, name);
  } else {
    for (I i = 0; i < n1; ++i) SA1[s1[i]] = i;
  }

  // Stage 4: place LMS suffixes in their final order and induce the rest.
  for (I i = 1, j = 0; i < n; ++i)
    if (is_lms(i)) s1[j++] = i;           // LMS positions in text order
  for (I i = 0; i < n1; ++i) SA1[i] = s1[SA1[i]];
  std::fill(SA + n1, SA + n, EMPTY);
  fill_buckets(true);
  for (I i = n1 - 1; i >= 0; --i) {
    I j = SA[i];
    SA[i] = EMPTY;
    SA[--bkt[s[j]]] = j;
  }
  induce();
}

template <typename I>
int sais_u8_impl(const uint8_t* T, int64_t* SA_out, int64_t n) {
  // Append an explicit sentinel (shift symbols by +1 so 0 is unique minimum).
  std::vector<I> s(n + 1);
  for (int64_t i = 0; i < n; ++i) s[i] = static_cast<I>(T[i]) + 1;
  s[n] = 0;
  std::vector<I> SA(n + 1);
  sais_core<I>(s.data(), SA.data(), static_cast<I>(n + 1), I(257));
  // SA[0] is the sentinel suffix; drop it.
  for (int64_t i = 0; i < n; ++i) SA_out[i] = static_cast<int64_t>(SA[i + 1]);
  return 0;
}

}  // namespace

extern "C" {

// Scan a `.pre` seed-table file (variable-size records: int32 count then
// count x 16-byte intervals; store_sa_interval_list, align.c:144-152) and
// emit the per-entry counts.  Sizes are data-dependent, so the walk is
// inherently sequential -- done here instead of a 16.7M-iteration Python
// loop (k=12 tables).  Returns entries decoded, or -1 on truncation.
int64_t bwbble_pre_scan(const uint8_t* data, int64_t len, int64_t n,
                        int32_t* cnt_out) {
  int64_t pos = 0;
  for (int64_t e = 0; e < n; ++e) {
    if (pos + 4 > len) return -1;
    int32_t c;
    std::memcpy(&c, data + pos, 4);
    if (c < 0 || pos + 4 + int64_t{16} * c > len) return -1;
    cnt_out[e] = c;
    pos += 4 + int64_t{16} * c;
  }
  return n;
}

// Suffix array of T[0..n-1] (bytes).  SA receives n entries.
int bwbble_sais_u8(const uint8_t* T, int64_t* SA, int64_t n) {
  if (n <= 0) return 0;
  if (n + 1 < (int64_t{1} << 31))
    return sais_u8_impl<int32_t>(T, SA, n);
  return sais_u8_impl<int64_t>(T, SA, n);
}

// Occurrence checkpoints for a 16-symbol BWT: out[k*16 + c] = number of
// occurrences of c in bwt[0 .. k*interval] (inclusive), skipping the sa0
// sentinel row (semantics of mg-aligner/bwt.c:280-291).
void bwbble_build_occ(const uint8_t* bwt, int64_t n, int64_t sa0,
                      int64_t interval, int64_t* out) {
  int64_t counts[16] = {0};
  int64_t k = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (i != sa0) counts[bwt[i]]++;
    if (i % interval == 0) {
      std::memcpy(out + k * 16, counts, sizeof(counts));
      ++k;
    }
  }
}

// ---------------------------------------------------------------- FASTQ

namespace {
// nt4 encoding (A=0, G=1, C=2, T=3, everything else N=4; io.h:113-130)
// and nt4 complement (io.h:110), matching bwbble_tpu.constants.
struct Nt4Tables {
  int8_t enc[256];
  int8_t compl_[5] = {3, 2, 1, 0, 4};
  Nt4Tables() {
    std::fill(enc, enc + 256, int8_t(4));
    enc['A'] = enc['a'] = 0;
    enc['G'] = enc['g'] = 1;
    enc['C'] = enc['c'] = 2;
    enc['T'] = enc['t'] = 3;
  }
};
const Nt4Tables kNt4;

inline int64_t find_byte(const uint8_t* d, int64_t from, int64_t n,
                         uint8_t c) {
  const void* p = std::memchr(d + from, c, static_cast<size_t>(n - from));
  return p ? static_cast<const uint8_t*>(p) - d : -1;
}

// One record scan step shared by both passes.  Returns 1 on a parsed
// record, 0 at end of input, -1 on malformed input.  Mirrors
// bwbble_tpu.formats.fastq.parse_fastq_bytes exactly.
struct Rec {
  int64_t name_off, name_len, seq_off, seq_len, qual_off;
};
int next_record(const uint8_t* d, int64_t n, int64_t* pos, Rec* r) {
  int64_t at = find_byte(d, *pos, n, '@');
  if (at < 0) return 0;
  int64_t nl = find_byte(d, at, n, '\n');
  if (nl < 0) return 0;
  r->name_off = at + 1;
  r->name_len = std::min<int64_t>(nl - (at + 1), 256);
  int64_t snl = find_byte(d, nl + 1, n, '\n');
  if (snl < 0) return -1;
  int64_t seq_end = snl;
  while (seq_end > nl + 1 && d[seq_end - 1] == '\r') --seq_end;
  r->seq_off = nl + 1;
  r->seq_len = seq_end - (nl + 1);
  int64_t plus = find_byte(d, snl, n, '+');
  if (plus < 0) return -1;
  int64_t pnl = find_byte(d, plus, n, '\n');
  if (pnl < 0) return -1;
  int64_t qnl = find_byte(d, pnl + 1, n, '\n');
  if (qnl < 0) qnl = n;
  int64_t qual_end = qnl;
  while (qual_end > pnl + 1 && d[qual_end - 1] == '\r') --qual_end;
  r->qual_off = pnl + 1;
  if (qual_end - r->qual_off != r->seq_len) return -1;
  *pos = qnl + 1;
  return 1;
}
}  // namespace

// Pass 1: count records and the maximum read length.  Returns the record
// count, or -1 on malformed input (callers fall back to the Python parser
// for error reporting).
int64_t bwbble_fastq_scan(const uint8_t* data, int64_t n, int64_t* max_len) {
  int64_t pos = 0, count = 0, ml = 0;
  Rec r;
  int st;
  while ((st = next_record(data, n, &pos, &r)) == 1) {
    ++count;
    if (r.seq_len > ml) ml = r.seq_len;
    if (pos >= n) break;
  }
  if (st < 0) return -1;
  *max_len = ml;
  return count;
}

// Pass 2: fill fixed-shape batches.  seq/rc are [count, max_len] int8
// padded with 4 (N); offsets let the caller slice names/quals lazily.
int bwbble_fastq_fill(const uint8_t* data, int64_t n, int64_t count,
                      int64_t max_len, int8_t* seq, int8_t* rc,
                      int32_t* lengths, int64_t* name_off, int64_t* name_len,
                      int64_t* qual_off) {
  int64_t pos = 0;
  Rec r;
  for (int64_t i = 0; i < count; ++i) {
    if (next_record(data, n, &pos, &r) != 1) return -1;
    name_off[i] = r.name_off;
    name_len[i] = r.name_len;
    qual_off[i] = r.qual_off;
    lengths[i] = static_cast<int32_t>(r.seq_len);
    int8_t* srow = seq + i * max_len;
    int8_t* rrow = rc + i * max_len;
    std::fill(srow, srow + max_len, int8_t(4));
    std::fill(rrow, rrow + max_len, int8_t(4));
    for (int64_t j = 0; j < r.seq_len; ++j) {
      int8_t c = kNt4.enc[data[r.seq_off + j]];
      srow[j] = c;
      rrow[r.seq_len - 1 - j] = kNt4.compl_[c];
    }
  }
  return 0;
}

// ----------------------------------------------------- multiref D bounds
//
// Host-side lower-bound computation with UNBOUNDED interval lists, used
// when a read's lists exceed the device engine's fixed slot capacity
// (on IUPAC-dense multi-genomes the exact forward scan can carry
// thousands of disjoint SA intervals; the reference's calculate_d keeps
// them in unbounded linked lists, inexact_match.c:171-254).  Semantics
// mirror bwbble_tpu/gold/engine.py::calculate_d and are byte-parity
// tested against it.  Rank queries run on caller-provided BWT bit planes
// (4 x uint64 words) with masked popcounts.

namespace {

struct DIdx {
  const uint64_t* planes;  // [4][nwords], bit t of code at position p is
                           // planes[t*nwords + p/64] bit (p%64)
  int64_t nwords;
  const int64_t* occ;      // [nb, 16] checkpoint counts (sentinel-skipped)
  const int64_t* Carr;     // [17]
  int64_t length, sa0, interval;
  // optional fused layout (interval == 128 only): one 128-byte row per
  // 128-position block = [p0w0,p0w1,p1w0,p1w1,p2w0,p2w1,p3w0,p3w1,
  // occ[0..15] as u32 pairs].  The rank walk is DRAM-latency-bound (the
  // separate [nb,16] occ table plus 4 scattered plane words cost ~5 cache
  // misses per query); the fused row is 2 adjacent lines.  Built host-side
  // (FMIndex.fused_planes), lengths < 2^31 only (u32 counters).
  const uint64_t* fused = nullptr;

  int64_t occ_f(int64_t k, int c) const {
    return int64_t(uint32_t(fused[k * 16 + 8 + (c >> 1)] >> ((c & 1) * 32)));
  }

  // in-block counts of positions [k*128+1, k*128+li] for all 16 codes
  // (li == 0 contributes nothing: the masks cancel)
  void count_block16(int64_t k, int64_t li, int64_t cnts[16]) const {
    const uint64_t* blk = fused + k * 16;
#if defined(__AVX512VPOPCNTDQ__) && defined(__AVX512F__)
    // codes 0-7 in one zmm, 8-15 in the other: lane c accumulates
    // popcount(AND over t of (bit t of c ? p_t : ~p_t) & mask)
    __m512i acc_lo = _mm512_setzero_si512();
    __m512i acc_hi = _mm512_setzero_si512();
    const __mmask8 kb0 = 0xAA, kb1 = 0xCC, kb2 = 0xF0;
    for (int w = 0; w <= int(li >> 6); ++w) {
      uint64_t mask = ~uint64_t(0);
      if (w == 0) mask &= ~uint64_t(1);
      int hi = int(li - w * 64);
      if (hi < 63) mask &= (uint64_t(1) << (hi + 1)) - 1;
      __m512i v_lo = _mm512_set1_epi64(int64_t(mask));
      __m512i v_hi = v_lo;
      for (int t = 0; t < 3; ++t) {
        uint64_t p = blk[2 * t + w];
        __mmask8 kt = (t == 0) ? kb0 : (t == 1) ? kb1 : kb2;
        __m512i sel = _mm512_mask_blend_epi64(
            kt, _mm512_set1_epi64(int64_t(~p)), _mm512_set1_epi64(int64_t(p)));
        v_lo = _mm512_and_epi64(v_lo, sel);
        v_hi = _mm512_and_epi64(v_hi, sel);
      }
      uint64_t p3 = blk[6 + w];
      v_lo = _mm512_and_epi64(v_lo, _mm512_set1_epi64(int64_t(~p3)));
      v_hi = _mm512_and_epi64(v_hi, _mm512_set1_epi64(int64_t(p3)));
      acc_lo = _mm512_add_epi64(acc_lo, _mm512_popcnt_epi64(v_lo));
      acc_hi = _mm512_add_epi64(acc_hi, _mm512_popcnt_epi64(v_hi));
    }
    int64_t tmp[16];
    _mm512_storeu_si512((__m512i*)tmp, acc_lo);
    _mm512_storeu_si512((__m512i*)(tmp + 8), acc_hi);
    for (int c = 0; c < 16; ++c) cnts[c] += tmp[c];
#else
    for (int w = 0; w <= int(li >> 6); ++w) {
      uint64_t mask = ~uint64_t(0);
      if (w == 0) mask &= ~uint64_t(1);
      int hi = int(li - w * 64);
      if (hi < 63) mask &= (uint64_t(1) << (hi + 1)) - 1;
      uint64_t p0 = blk[0 + w], p1 = blk[2 + w], p2 = blk[4 + w],
               p3 = blk[6 + w];
      uint64_t s0[2] = {~p0 & mask, p0 & mask};
      uint64_t s1[2] = {~p1, p1};
      uint64_t s2[2] = {~p2, p2};
      uint64_t s3[2] = {~p3, p3};
      for (int c = 0; c < 16; ++c)
        cnts[c] += __builtin_popcountll(s0[c & 1] & s1[(c >> 1) & 1] &
                                        s2[(c >> 2) & 1] & s3[(c >> 3) & 1]);
    }
#endif
  }

  // #positions in [a, b] whose code equals c (a >= 0)
  int64_t count_range(int c, int64_t a, int64_t b) const {
    if (a > b) return 0;
    int64_t w0 = a >> 6, w1 = b >> 6, cnt = 0;
    for (int64_t w = w0; w <= w1; ++w) {
      uint64_t m = ~uint64_t(0);
      for (int t = 0; t < 4; ++t) {
        uint64_t pl = planes[t * nwords + w];
        m &= ((c >> t) & 1) ? pl : ~pl;
      }
      if (w == w0) m &= ~uint64_t(0) << (a & 63);
      if (w == w1) {
        int hi = int(b & 63);
        m &= (hi == 63) ? ~uint64_t(0) : ((uint64_t(1) << (hi + 1)) - 1);
      }
      cnt += __builtin_popcountll(m);
    }
    return cnt;
  }

  int64_t O(int c, int64_t i) const {
    if (i == length - 1) return Carr[c + 1] - Carr[c];
    if (i < 0) return 0;
    int64_t k = i / interval, base = k * interval;
    int64_t cnt = count_range(c, base + 1, i);
    if (c == 0 && base < sa0 && sa0 <= i) --cnt;  // bwt.c:363-369
    return occ[k * 16 + c] + cnt;
  }

  // O(c, i) for ALL 16 codes in one walk over the (at most interval/64)
  // plane words — the 7-base interval steps in calc_d/exact completion
  // would otherwise re-walk the same words 14x per interval.
  void O_all(int64_t i, int64_t out[16]) const {
    if (i == length - 1) {
      for (int c = 0; c < 16; ++c) out[c] = Carr[c + 1] - Carr[c];
      return;
    }
    if (i < 0) {
      for (int c = 0; c < 16; ++c) out[c] = 0;
      return;
    }
    if (fused) {
      int64_t k = i >> 7;
      int64_t cnts[16] = {0};
      count_block16(k, i & 127, cnts);
      if ((k << 7) < sa0 && sa0 <= i) --cnts[0];  // bwt.c:363-369
      for (int c = 0; c < 16; ++c) out[c] = occ_f(k, c) + cnts[c];
      return;
    }
    int64_t k = i / interval, base = k * interval;
    int64_t cnts[16] = {0};
    int64_t a = base + 1;
    if (a <= i) {
      int64_t w0 = a >> 6, w1 = i >> 6;
      for (int64_t w = w0; w <= w1; ++w) {
        uint64_t p0 = planes[w];
        uint64_t p1 = planes[nwords + w];
        uint64_t p2 = planes[2 * nwords + w];
        uint64_t p3 = planes[3 * nwords + w];
        uint64_t mask = ~uint64_t(0);
        if (w == w0) mask &= ~uint64_t(0) << (a & 63);
        if (w == w1) {
          int hi = int(i & 63);
          mask &= (hi == 63) ? ~uint64_t(0)
                             : ((uint64_t(1) << (hi + 1)) - 1);
        }
        uint64_t s0[2] = {~p0 & mask, p0 & mask};
        uint64_t s1[2] = {~p1, p1};
        uint64_t s2[2] = {~p2, p2};
        uint64_t s3[2] = {~p3, p3};
        for (int c = 0; c < 16; ++c)
          cnts[c] += __builtin_popcountll(s0[c & 1] & s1[(c >> 1) & 1] &
                                          s2[(c >> 2) & 1] & s3[(c >> 3) & 1]);
      }
    }
    if (base < sa0 && sa0 <= i) --cnts[0];  // bwt.c:363-369
    for (int c = 0; c < 16; ++c) out[c] = occ[k * 16 + c] + cnts[c];
  }
};

}  // namespace

namespace {

void calc_d_core(const DIdx& ix, const uint8_t* nucl_bases, int nb_per,
                 const int8_t* read, int64_t read_len, int64_t* D);

}  // namespace

extern "C" int bwbble_calc_d_multiref(
    const uint64_t* planes, int64_t nwords, const int64_t* occ,
    const int64_t* Carr, int64_t length, int64_t sa0, int64_t interval,
    const uint8_t* nucl_bases, int nb_per, const int8_t* read,
    int64_t read_len, int64_t* D /* [read_len+1][2] */) {
  DIdx ix{planes, nwords, occ, Carr, length, sa0, interval};
  calc_d_core(ix, nucl_bases, nb_per, read, read_len, D);
  return 0;
}

namespace {

void calc_d_core(const DIdx& ix, const uint8_t* nucl_bases, int nb_per,
                 const int8_t* read, int64_t read_len, int64_t* D) {
  const int64_t* Carr = ix.Carr;
  const int64_t full_L = 0, full_U = ix.length - 1;
  std::vector<std::pair<int64_t, int64_t>> curr, next;
  curr.emplace_back(full_L, full_U);
  int64_t z = 0;
  for (int64_t i = read_len - 1; i >= 0; --i) {
    int c = read[i];
    int64_t num_matches = 0;
    if (c < 0 || c > 3) {
      curr.clear();
    } else {
      next.clear();
      int64_t Olo[16], Ohi[16];
      size_t ncur = curr.size();
      for (size_t q = 0; q < ncur; ++q) {
        const auto& lu = curr[q];
        if (ix.fused && q + 1 < ncur) {
          // the next interval's fused rows are independent loads — issue
          // them now so their DRAM latency overlaps this interval's math
          __builtin_prefetch(ix.fused + ((curr[q + 1].first - 1) >> 7) * 16);
          __builtin_prefetch(ix.fused + (curr[q + 1].second >> 7) * 16);
        }
        ix.O_all(lu.first - 1, Olo);
        ix.O_all(lu.second, Ohi);
        for (int b = 0; b < nb_per; ++b) {
          int base = nucl_bases[c * nb_per + b];
          int64_t L = Carr[base] + Olo[base] + 1;
          int64_t U = Carr[base] + Ohi[base];
          if (L <= U) {
            num_matches += U - L + 1;
            // adjoining-interval merge on insert (add_sa_interval,
            // align.c:93-110)
            if (!next.empty() && L == next.back().second + 1)
              next.back().second = U;
            else
              next.emplace_back(L, U);
          }
        }
      }
      curr.swap(next);
    }
    if (curr.empty()) {
      curr.emplace_back(full_L, full_U);
      ++z;
      num_matches = full_U - full_L + 1;
    }
    D[(read_len - 1 - i) * 2] = z;
    D[(read_len - 1 - i) * 2 + 1] = num_matches;
  }
  D[read_len * 2] = z + 1;
  D[read_len * 2 + 1] = 0;
}

}  // namespace

// --------------------------------------------------------- gold DFS engine
//
// Host fallback for reads whose search state exceeds the device engine's
// fixed capacities (deep repeat/IUPAC pathologies).  This is a C++ port of
// the package's own reference-semantics model, bwbble_tpu/gold/engine.py
// (inexact_match + exact_match_bounded + the score-bucket heap), and is
// byte-parity tested against it; that Python model in turn mirrors the
// published BWA-style bounded search (inexact_match.c:256-506).  ~100-500x
// faster than the Python model per read, which turns fallback storms from
// minutes into milliseconds.

namespace {

constexpr int kPathCap = 256;  // reads are capped at 255 upstream (Q5)

// State paths live in an append-only (parent, state) arena shared by all
// entries of one read — a push records 8 bytes instead of copying the
// parent's path (the reference and the first native port copied a 256-byte
// path per push/pop, ~1 KB of pure memory traffic per expansion); paths
// are reconstructed only for the handful of reported alignments.
struct PathNode {
  int32_t parent;  // arena id, -1 at the root
  uint8_t state;
};

struct GEntry {
  int64_t L, U;
  int32_t i, mm, go, ge, state, snps, score;
  int32_t path_len;  // clamped at kPathCap (matches the reference's cap)
  int32_t node;      // PathNode arena id, -1 at the root
  GEntry() {}  // intentionally uninitialized: every field is filled at the
               // push site
};

struct GoldHeap {
  std::vector<std::vector<GEntry>> buckets;
  int64_t best, count = 0;
  explicit GoldHeap(int64_t nb) : buckets(nb), best(nb) {}
  // Entries are constructed IN PLACE in their score bucket — no stack
  // temporary, no struct copy (the 304-byte entry would otherwise be
  // memset + copied twice per push; same LIFO order as push_back).
  GEntry& emplace(int64_t s) {
    auto& b = buckets[s];
    b.emplace_back();
    ++count;
    if (s < best) best = s;
    return b.back();
  }
  GEntry pop() {
    auto& b = buckets[best];
    GEntry e = std::move(b.back());
    b.pop_back();
    --count;
    if (b.empty() && count) {
      int64_t s = best + 1;
      int64_t nb = static_cast<int64_t>(buckets.size());
      while (s < nb && buckets[s].empty()) ++s;
      best = s;
    } else if (count == 0) {
      best = static_cast<int64_t>(buckets.size());
    }
    return e;
  }
};

struct GoldTables {
  const uint8_t* nucl_bases;  // [4][7]
  const uint8_t* gray_val;    // [16]
  const uint8_t* nt4_gray_val;  // [5]
  const uint8_t* is_snp;      // [16]
  const uint8_t* skipped;     // [16] 1 = B/H/V/D (quirk Q1)
};

// All-chars bound vector with quirk Q1 semantics
// (FMIndex.O_alphabet; bwt.c:374-438 + get_occ_count_alphabet :689-781).
// One pass over the (at most interval/64) plane words counts ALL codes at
// once — the per-code count_range calls would reload the same four plane
// words 11x (the reference's analog is the SSE one-pass in bwt.c:689-781).
void o_alphabet(const DIdx& ix, const GoldTables& t, int64_t i, int64_t inc,
                int64_t out[16]) {
  out[0] = 0;
  if (i == ix.length - 1) {
    for (int j = 1; j < 16; ++j) out[j] = ix.Carr[j + 1] + inc;
    return;
  }
  if (i < 0) {
    for (int j = 1; j < 16; ++j) out[j] = ix.Carr[j] + inc;
    return;
  }
  if (ix.fused) {
    int64_t k = i >> 7;
    const uint64_t* blk = ix.fused + k * 16;
    int first = 0;
    for (int tt = 0; tt < 4; ++tt)
      first |= int(blk[2 * tt] & 1) << tt;
    int64_t cnts[16] = {0};
    ix.count_block16(k, i & 127, cnts);
    for (int j = 1; j < 16; ++j)
      out[j] = t.skipped[j]
                   ? ix.Carr[j] + inc - (first == j ? 1 : 0)
                   : ix.Carr[j] + ix.occ_f(k, j) + cnts[j] + inc;
    return;
  }
  int64_t k = i / ix.interval, base = k * ix.interval;
  int first = 0;
  for (int tt = 0; tt < 4; ++tt)
    first |= ((ix.planes[tt * ix.nwords + (base >> 6)] >> (base & 63)) & 1)
             << tt;
  int64_t cnts[16] = {0};
  int64_t a = base + 1, b = i;
  if (a <= b) {
    int64_t w0 = a >> 6, w1 = b >> 6;
    for (int64_t w = w0; w <= w1; ++w) {
      uint64_t p0 = ix.planes[w];
      uint64_t p1 = ix.planes[ix.nwords + w];
      uint64_t p2 = ix.planes[2 * ix.nwords + w];
      uint64_t p3 = ix.planes[3 * ix.nwords + w];
      uint64_t mask = ~uint64_t(0);
      if (w == w0) mask &= ~uint64_t(0) << (a & 63);
      if (w == w1) {
        int hi = int(b & 63);
        mask &= (hi == 63) ? ~uint64_t(0) : ((uint64_t(1) << (hi + 1)) - 1);
      }
      uint64_t s0[2] = {~p0 & mask, p0 & mask};
      uint64_t s1[2] = {~p1, p1};
      uint64_t s2[2] = {~p2, p2};
      uint64_t s3[2] = {~p3, p3};
      for (int j = 1; j < 16; ++j)
        cnts[j] += __builtin_popcountll(s0[j & 1] & s1[(j >> 1) & 1] &
                                        s2[(j >> 2) & 1] & s3[(j >> 3) & 1]);
    }
  }
  for (int j = 1; j < 16; ++j) {
    if (t.skipped[j]) {
      // no checkpoint/in-block count; only the double-count decrement of
      // the checkpoint's first char leaks through (quirk Q1, bwt.c:780)
      out[j] = ix.Carr[j] + inc - (first == j ? 1 : 0);
    } else {
      // the in-block count is base-EXCLUSIVE, so no first-char decrement
      out[j] = ix.Carr[j] + ix.occ[k * 16 + j] + cnts[j] + inc;
    }
  }
}

// merged-on-insert interval list append (add_sa_interval, align.c:93-110)
inline void add_intv(std::vector<std::pair<int64_t, int64_t>>& v, int64_t L,
                     int64_t U) {
  if (!v.empty() && L == v.back().second + 1)
    v.back().second = U;
  else
    v.emplace_back(L, U);
}

// exact-completion interval-list statistics (device-engine KX sizing):
// max list size and total list-size-steps across all completions since the
// last reset.  Thread-local: the gold pool forks worker processes.
thread_local int64_t g_xlist_max = 0, g_xlist_total = 0;

// exact completion scan (exact_match_bounded, exact_match.c:66-119)
std::vector<std::pair<int64_t, int64_t>> exact_bounded(
    const DIdx& ix, const GoldTables& t, const int8_t* read, int64_t l,
    int64_t u, int64_t i) {
  // thread_local scratch: called once per diff_left==0 pop, so per-call
  // vector growth would dominate the short scans
  static thread_local std::vector<std::pair<int64_t, int64_t>> curr, nxt;
  curr.assign(1, {l, u});
  nxt.clear();
  int64_t Olo[16], Ohi[16];
  for (int64_t r = i; r >= 0; --r) {
    int c = read[r];
    if (c < 0 || c > 3) return {};
    nxt.clear();
    size_t ncur = curr.size();
    for (size_t q = 0; q < ncur; ++q) {
      const auto& lu = curr[q];
      if (ix.fused && q + 1 < ncur) {
        __builtin_prefetch(ix.fused + ((curr[q + 1].first - 1) >> 7) * 16);
        __builtin_prefetch(ix.fused + (curr[q + 1].second >> 7) * 16);
      }
      ix.O_all(lu.first - 1, Olo);
      ix.O_all(lu.second, Ohi);
      for (int b = 0; b < 7; ++b) {
        int base = t.nucl_bases[c * 7 + b];
        int64_t L = ix.Carr[base] + Olo[base] + 1;
        int64_t U = ix.Carr[base] + Ohi[base];
        if (L <= U) add_intv(nxt, L, U);
      }
    }
    curr.swap(nxt);
    if ((int64_t)curr.size() > g_xlist_max) g_xlist_max = curr.size();
    g_xlist_total += (int64_t)curr.size();
    if (curr.empty()) break;
  }
  return curr;
}

struct GoldParams {
  int64_t mm, go, ge, max_diff, max_gapo, max_gape, seed_len, max_diff_seed,
      max_best, no_indel, max_entries, num_buckets;
  int64_t score(int64_t m, int64_t o, int64_t e) const {
    return m * mm + o * go + e * ge;
  }
};

struct GoldOut {
  int64_t cap, n = 0;
  int64_t* meta;     // [cap][8]: score,L,U,mm,go,ge,snps,len
  uint8_t* paths;    // [cap][kPathCap]
  const std::vector<PathNode>* arena = nullptr;
  bool overflow = false;

  // record with the gap-dedup of add_alignment (align.c:271-298)
  void add(const GEntry& e, int64_t L, int64_t U, int64_t score,
           int64_t aln_length) {
    if (e.go) {
      for (int64_t a = 0; a < n; ++a)
        if (meta[a * 8 + 1] == L && meta[a * 8 + 2] == U) return;
    }
    if (n >= cap) {
      overflow = true;
      return;
    }
    int64_t* m = meta + n * 8;
    m[0] = score; m[1] = L; m[2] = U; m[3] = e.mm; m[4] = e.go; m[5] = e.ge;
    m[6] = e.snps; m[7] = aln_length;
    uint8_t* pp = paths + n * kPathCap;
    std::memset(pp, 0, kPathCap);
    // reconstruct push-order states from the parent chain (deepest first);
    // tmp bound: path depth <= read_len + total deletions << 512
    uint8_t tmp[512];
    int32_t depth = 0, nd = e.node;
    while (nd >= 0 && depth < 512) {
      tmp[depth++] = (*arena)[nd].state;
      nd = (*arena)[nd].parent;
    }
    int64_t mlen = std::min<int64_t>(
        std::min<int64_t>(e.path_len, aln_length), depth);
    for (int64_t q = 0; q < mlen; ++q) pp[q] = tmp[depth - 1 - q];
    ++n;
  }
};

}  // namespace

extern "C" void bwbble_dbg_oalpha(
    const uint64_t* planes, int64_t nwords, const int64_t* occ,
    const int64_t* Carr, int64_t length, int64_t sa0, int64_t interval,
    const uint8_t* tables, int64_t i, int64_t inc, int64_t* out16) {
  DIdx ix{planes, nwords, occ, Carr, length, sa0, interval};
  GoldTables t{tables, tables + 28, tables + 44, tables + 49, tables + 65};
  o_alphabet(ix, t, i, inc, out16);
}

namespace {

int64_t gold_align_impl(
    const DIdx& ix,
    const uint8_t* tables /* nucl_bases 28 | gray_val 16 | nt4_gray_val 5 |
                             is_snp 16 | skipped 16 */,
    const int64_t* pp /* GoldParams fields in order */, const int8_t* seq,
    const int8_t* rc, int64_t read_len, int64_t cap, int64_t* out_meta,
    uint8_t* out_paths, int64_t* n_pops /* nullable diagnostics */) {
  if (read_len <= 0 || read_len > 255) return -2;
  GoldTables t{tables, tables + 28, tables + 44, tables + 49, tables + 65};
  GoldParams p;
  std::memcpy(&p, pp, sizeof(p));
  GoldOut out{cap, 0, out_meta, out_paths};

  int64_t count_n = 0;
  for (int64_t i = 0; i < read_len; ++i) count_n += (rc[i] > 3 || rc[i] < 0);
  if (count_n > p.max_diff) return 0;

  // D bounds from the forward sequence (align_read_gold,
  // bwbble_tpu/align/pipeline.py; D rows are (num_diff, width))
  std::vector<int64_t> D((read_len + 1) * 2), Ds;
  calc_d_core(ix, t.nucl_bases, 7, seq, read_len, D.data());
  int64_t seed_n = 0;
  if (p.seed_len > 0 && read_len > p.seed_len) {
    seed_n = p.seed_len;
    Ds.resize((seed_n + 1) * 2);
    calc_d_core(ix, t.nucl_bases, 7, seq, seed_n, Ds.data());
  } else {
    Ds.assign((p.seed_len + 1) * 2, 0);
  }

  static thread_local std::vector<PathNode> arena;
  arena.clear();
  out.arena = &arena;
  GoldHeap heap(p.num_buckets);
  {
    GEntry& root = heap.emplace(0);
    root.L = 0; root.U = ix.length - 1; root.i = int32_t(read_len);
    root.mm = 0; root.go = 0; root.ge = 0; root.snps = 0;
    root.state = 0; root.path_len = 0; root.score = 0; root.node = -1;
  }
  int64_t best_score = p.score(p.max_diff + 1, p.max_gapo + 1,
                               p.max_gape + 1);
  int64_t max_diff = p.max_diff, num_best = 0;
  const int STATE_M = 0, STATE_I = 1, STATE_D = 2;

  int64_t pops = 0;
  while (heap.count != 0) {
    if (heap.count > p.max_entries) break;
    GEntry e = heap.pop();
    ++pops;
    if (ix.fused) {
      // the expansion's two rank rows are independent of the pruning
      // math below — start their DRAM fetches now
      __builtin_prefetch(ix.fused + ((e.L - 1) >> 7) * 16);
      __builtin_prefetch(ix.fused + (e.U >> 7) * 16);
    }

    if (e.score > best_score + p.mm) break;
    int64_t diff_left = max_diff - e.mm - e.go - e.ge;
    if (diff_left < 0) continue;
    if (e.i > 0 && diff_left < D[(e.i - 1) * 2]) continue;
    int64_t dls = p.max_diff_seed - e.mm - e.go - e.ge;
    int64_t seed_index = e.i - (read_len - p.seed_len);
    if (seed_index > 0 && dls < Ds[(seed_index - 1) * 2]) continue;

    if (e.i == 0) {
      int64_t score = p.score(e.mm, e.go, e.ge);
      if (out.n == 0) {
        best_score = score;
        max_diff = std::min<int64_t>(e.mm + e.go + e.ge + 1, p.max_diff);
      }
      if (score == best_score)
        num_best += e.U - e.L + 1;
      else if (num_best > p.max_best)
        break;
      out.add(e, e.L, e.U, score, e.path_len);
      if (out.overflow) return -1;
      continue;
    }

    if (diff_left == 0) {
      auto intvs = exact_bounded(ix, t, rc, e.L, e.U, e.i - 1);
      if (!intvs.empty()) {
        int64_t score = p.score(e.mm, e.go, e.ge);
        if (out.n == 0) {
          best_score = score;
          max_diff = std::min<int64_t>(e.mm + e.go + e.ge + 1, p.max_diff);
        }
        if (score == best_score) {
          for (const auto& lu : intvs) num_best += lu.second - lu.first + 1;
        } else if (num_best > p.max_best) {
          break;
        }
        int64_t aln_length = e.path_len + e.i;
        for (const auto& lu : intvs) {
          out.add(e, lu.first, lu.second, score, aln_length);
          if (out.overflow) return -1;
        }
      }
      continue;
    }

    int64_t Lv[16], Uv[16];
    o_alphabet(ix, t, e.L - 1, 1, Lv);
    o_alphabet(ix, t, e.U, 0, Uv);

    bool allow_diff = true, allow_indels = true, allow_mm = true;
    bool allow_open = e.go < p.max_gapo, allow_extend = e.ge < p.max_gape;
    if (e.i - 1 > 0) {
      if (diff_left - 1 < D[(e.i - 2) * 2])
        allow_diff = false;
      else if (D[(e.i - 1) * 2] == diff_left - 1 &&
               D[(e.i - 2) * 2] == diff_left - 1 &&
               D[(e.i - 1) * 2 + 1] == D[(e.i - 2) * 2 + 1])
        allow_mm = false;
    }
    if (seed_index - 1 > 0) {
      if (dls - 1 < Ds[(seed_index - 2) * 2])
        allow_diff = false;
      else if (Ds[(seed_index - 1) * 2] == dls - 1 &&
               Ds[(seed_index - 2) * 2] == dls - 1 &&
               Ds[(seed_index - 1) * 2 + 1] == Ds[(seed_index - 2) * 2 + 1])
        allow_mm = false;
    }
    int64_t tmp = e.go + e.ge;
    if (e.i - 1 < p.no_indel + tmp ||
        (read_len - (e.i - 1)) < p.no_indel + tmp)
      allow_indels = false;
    if (e.go >= p.max_gapo && e.ge >= p.max_gape) allow_indels = false;

    auto push = [&](int32_t i, int64_t L, int64_t U, int32_t mm, int32_t go,
                    int32_t ge, int32_t state, int32_t snps) {
      int32_t score = int32_t(p.score(mm, go, ge));
      GEntry& c = heap.emplace(score);
      c.L = L; c.U = U; c.i = i; c.mm = mm; c.go = go; c.ge = ge;
      c.state = state; c.snps = snps & 0xFF;
      c.score = score;
      c.path_len = std::min<int32_t>(e.path_len + 1, kPathCap);
      c.node = int32_t(arena.size());
      arena.push_back(PathNode{e.node, uint8_t(state)});
    };

    // INDELS (inexact_match.c:434-463)
    if (allow_diff && allow_indels) {
      if (e.state == STATE_I) {
        if (allow_extend)
          push(e.i - 1, e.L, e.U, e.mm, e.go, e.ge + 1, STATE_I, e.snps);
      } else {
        if (allow_open && e.state == STATE_M)
          push(e.i - 1, e.L, e.U, e.mm, e.go + 1, e.ge, STATE_I, e.snps);
        for (int j = 1; j < 16; ++j) {
          if (Lv[j] <= Uv[j]) {
            if (e.state == STATE_M) {
              if (allow_open)
                push(e.i, Lv[j], Uv[j], e.mm, e.go + 1, e.ge, STATE_D,
                     e.snps);
            } else if (allow_extend) {
              push(e.i, Lv[j], Uv[j], e.mm, e.go, e.ge + 1, STATE_D, e.snps);
            }
          }
        }
      }
    }

    // MATCH / MISMATCH (inexact_match.c:465-504)
    int c = rc[e.i - 1];
    if (allow_diff && allow_mm) {
      for (int j = 1; j < 16; ++j) {
        if (Lv[j] <= Uv[j]) {
          bool is_mm = (c > 3 || c < 0 || t.gray_val[j] == 15 ||
                        (t.nt4_gray_val[c] & t.gray_val[j]) == 0);
          // j == ORDER_N is the gray_val[j] == 15 case above
          push(e.i - 1, Lv[j], Uv[j], e.mm + (is_mm ? 1 : 0), e.go, e.ge,
               STATE_M, e.snps + t.is_snp[j]);
        }
      }
    } else if (c >= 0 && c < 4) {
      for (int b = 0; b < 7; ++b) {
        int base = t.nucl_bases[c * 7 + b];
        if (Lv[base] <= Uv[base])
          push(e.i - 1, Lv[base], Uv[base], e.mm, e.go, e.ge, STATE_M,
               e.snps + t.is_snp[base]);
      }
    }
  }
  if (n_pops) *n_pops = pops;
  return out.n;
}

}  // namespace

extern "C" void bwbble_xlist_reset() {
  g_xlist_max = 0;
  g_xlist_total = 0;
}

extern "C" int64_t bwbble_xlist_stats(int64_t* total) {
  if (total) *total = g_xlist_total;
  return g_xlist_max;
}

extern "C" int64_t bwbble_gold_align_multiref(
    const uint64_t* planes, int64_t nwords, const int64_t* occ,
    const int64_t* Carr, int64_t length, int64_t sa0, int64_t interval,
    const uint8_t* tables, const int64_t* pp, const int8_t* seq,
    const int8_t* rc, int64_t read_len, int64_t cap, int64_t* out_meta,
    uint8_t* out_paths, int64_t* n_pops) {
  DIdx ix{planes, nwords, occ, Carr, length, sa0, interval};
  return gold_align_impl(ix, tables, pp, seq, rc, read_len, cap, out_meta,
                         out_paths, n_pops);
}

// fused-table variant: `fused` is FMIndex.fused_planes() (see DIdx.fused)
extern "C" int64_t bwbble_gold_align_multiref_f(
    const uint64_t* planes, int64_t nwords, const int64_t* occ,
    const int64_t* Carr, int64_t length, int64_t sa0, int64_t interval,
    const uint8_t* tables, const int64_t* pp, const int8_t* seq,
    const int8_t* rc, int64_t read_len, int64_t cap, int64_t* out_meta,
    uint8_t* out_paths, int64_t* n_pops, const uint64_t* fused) {
  DIdx ix{planes, nwords, occ, Carr, length, sa0, interval,
          interval == 128 ? fused : nullptr};
  return gold_align_impl(ix, tables, pp, seq, rc, read_len, cap, out_meta,
                         out_paths, n_pops);
}

extern "C" int bwbble_calc_d_multiref_f(
    const uint64_t* planes, int64_t nwords, const int64_t* occ,
    const int64_t* Carr, int64_t length, int64_t sa0, int64_t interval,
    const uint8_t* nucl_bases, int nb_per, const int8_t* read,
    int64_t read_len, int64_t* D /* [read_len+1][2] */,
    const uint64_t* fused) {
  DIdx ix{planes, nwords, occ, Carr, length, sa0, interval,
          interval == 128 ? fused : nullptr};
  calc_d_core(ix, nucl_bases, nb_per, read, read_len, D);
  return 0;
}

}  // extern "C"
