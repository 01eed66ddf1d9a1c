// Native host-side graph build helpers, loaded through ctypes.
//
// The compute path is JAX/XLA; the host-side preprocessing around it —
// the RMAT generator, the text edge-list parser, the reference's seeded
// square-id permutation and the triangle-counting prep — is native, like
// the reference's header-only C++ tile constructors
// (include/GMDP/matrices/DCSCTile.h:241-381).
//
// Exposed via a C ABI for ctypes (no pybind11 dependency).
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC planner.cpp -o libgmplanner.so

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

// ----------------------------------------------------------------------
// Text edge-list parser ("src dst [val]" rows) — the native counterpart
// of the reference's readLine/load_edgelist text path (edgelist.h:89-151),
// ~2.5x numpy.loadtxt's C reader on a 2-core box (scales with cores;
// loadtxt is single-threaded).  Two passes: per-chunk line counting + prefix sum,
// then parallel parse writing at global row offsets.  Returns the number
// of parsed edges (blank lines skipped); -1 on malformed input.
// val_kind: 0 = none (val untouched), 1 = int32, 2 = float32, 3 = float64.

namespace {

inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

inline const char* parse_i32(const char* p, const char* end, int32_t* out) {
  p = skip_ws(p, end);
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) neg = *p++ == '-';
  if (p >= end || *p < '0' || *p > '9') return nullptr;
  int64_t v = 0;
  while (p < end && *p >= '0' && *p <= '9') v = v * 10 + (*p++ - '0');
  *out = (int32_t)(neg ? -v : v);
  return p;
}

inline const char* parse_f64(const char* p, const char* end, double* out) {
  p = skip_ws(p, end);
  char* q = nullptr;
  *out = strtod(p, &q);
  if (q == p) return nullptr;
  return q;
}

}  // namespace

extern "C" {

int64_t gm_parse_text_edges(const char* buf, int64_t len, int32_t val_kind,
                            int32_t* src, int32_t* dst, void* val) {
  const int nthreads =
#if defined(_OPENMP)
      omp_get_max_threads();
#else
      1;
#endif
  // chunk boundaries aligned to line starts
  std::vector<int64_t> starts(nthreads + 1, len);
  starts[0] = 0;
  for (int t = 1; t < nthreads; ++t) {
    int64_t pos = len * t / nthreads;
    while (pos < len && buf[pos] != '\n') ++pos;
    starts[t] = std::min(pos + 1, len);
  }
  starts[nthreads] = len;

  // pass 1: count non-blank lines per chunk
  std::vector<int64_t> cnt(nthreads, 0);
#pragma omp parallel for schedule(static) num_threads(nthreads)
  for (int t = 0; t < nthreads; ++t) {
    const char* p = buf + starts[t];
    const char* end = buf + starts[t + 1];
    int64_t c = 0;
    while (p < end) {
      const char* nl = (const char*)memchr(p, '\n', end - p);
      const char* stop = nl ? nl : end;
      const char* q = skip_ws(p, stop);
      if (q < stop) ++c;
      p = nl ? nl + 1 : end;
    }
    cnt[t] = c;
  }
  std::vector<int64_t> off(nthreads + 1, 0);
  for (int t = 0; t < nthreads; ++t) off[t + 1] = off[t] + cnt[t];

  // pass 2: parse
  std::atomic<bool> bad{false};
#pragma omp parallel for schedule(static) num_threads(nthreads)
  for (int t = 0; t < nthreads; ++t) {
    const char* p = buf + starts[t];
    const char* end = buf + starts[t + 1];
    int64_t i = off[t];
    while (p < end && !bad.load(std::memory_order_relaxed)) {
      const char* nl = (const char*)memchr(p, '\n', end - p);
      const char* stop = nl ? nl : end;
      const char* q = skip_ws(p, stop);
      if (q < stop) {
        q = parse_i32(q, stop, &src[i]);
        if (q) q = parse_i32(q, stop, &dst[i]);
        if (q && val_kind) {
          double d;
          q = parse_f64(q, stop, &d);
          if (q) {
            if (val_kind == 1) ((int32_t*)val)[i] = (int32_t)d;
            else if (val_kind == 2) ((float*)val)[i] = (float)d;
            else ((double*)val)[i] = d;
          }
        }
        if (!q) { bad.store(true, std::memory_order_relaxed); break; }
        ++i;
      }
      p = nl ? nl + 1 : end;
    }
  }
  return bad.load() ? -1 : off[nthreads];
}

}  // extern "C"

// ---------------------------------------------------------------------------
// RMAT generator (Graph500-style recursive bisection).
//
// Native counterpart of graphmat/utils/generators.py::rmat_edgelist.
// Counter-based: edge i's quadrant choices come from a splitmix64 stream
// seeded by (seed, i), so output is deterministic for a given seed
// regardless of thread count.  Self loops are always dropped; dedup != 0
// additionally sorts by (src, dst) and keeps one edge per pair (the
// python path's remove_duplicate_edges semantics; values are derived from
// the (src, dst) key so the kept edge's weight is order-independent).

#include <parallel/algorithm>

namespace {

inline uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ULL;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

}  // namespace

extern "C" {

// src_out/dst_out/val_out must hold nnz int32 each; returns the edge count
// actually written (after self-loop removal and optional dedup), 1-based ids.
int64_t gm_rmat_gen(int32_t scale, int64_t nnz, double a, double b, double c,
                    uint64_t seed, int32_t dedup, int32_t weight_range,
                    int32_t* src_out, int32_t* dst_out, int32_t* val_out) {
  const double ab = a + b;
  const double c_norm = c / (1.0 - ab);
  // P(dst=1 | src=0) = b/(a+b): threshold r2 against a/ab (using b/ab
  // swapped the a and b quadrants — see generators.py::rmat_edgelist)
  const double a_norm = a / ab;

  std::vector<uint64_t> keys(nnz);
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < nnz; ++i) {
    uint64_t state = splitmix64(seed * 0xD1342543DE82EF95ULL + (uint64_t)i);
    uint32_t s = 0, d = 0;
    for (int32_t lvl = 0; lvl < scale; ++lvl) {
      uint64_t x = state = splitmix64(state);
      double r1 = (uint32_t)(x >> 32) * 0x1.0p-32;
      double r2 = (uint32_t)x * 0x1.0p-32;
      int sb = r1 > ab;
      int db = sb ? (r2 > c_norm) : (r2 > a_norm);
      s = (s << 1) | (uint32_t)sb;
      d = (d << 1) | (uint32_t)db;
    }
    keys[i] = ((uint64_t)s << 32) | d;
  }

  if (dedup) {
    __gnu_parallel::sort(keys.begin(), keys.end());
  }

  // compact (drop self loops; with dedup also drop equal neighbors)
  int nthreads = 1;
#if defined(_OPENMP)
  nthreads = omp_get_max_threads();
#endif
  std::vector<int64_t> cnt(nthreads, 0), off(nthreads + 1, 0);
#pragma omp parallel for schedule(static) num_threads(nthreads)
  for (int t = 0; t < nthreads; ++t) {
    int64_t lo = nnz * t / nthreads, hi = nnz * (t + 1) / nthreads;
    int64_t n = 0;
    for (int64_t i = lo; i < hi; ++i) {
      uint32_t s = (uint32_t)(keys[i] >> 32), d = (uint32_t)keys[i];
      if (s == d) continue;
      if (dedup && i > 0 && keys[i] == keys[i - 1]) continue;
      ++n;
    }
    cnt[t] = n;
  }
  for (int t = 0; t < nthreads; ++t) off[t + 1] = off[t] + cnt[t];
#pragma omp parallel for schedule(static) num_threads(nthreads)
  for (int t = 0; t < nthreads; ++t) {
    int64_t lo = nnz * t / nthreads, hi = nnz * (t + 1) / nthreads;
    int64_t o = off[t];
    for (int64_t i = lo; i < hi; ++i) {
      uint32_t s = (uint32_t)(keys[i] >> 32), d = (uint32_t)keys[i];
      if (s == d) continue;
      if (dedup && i > 0 && keys[i] == keys[i - 1]) continue;
      src_out[o] = (int32_t)s + 1;
      dst_out[o] = (int32_t)d + 1;
      val_out[o] = weight_range > 0
          ? (int32_t)(1 + splitmix64(seed ^ keys[i]) % (uint64_t)weight_range)
          : 1;
      ++o;
    }
  }
  return off[nthreads];
}

}  // extern "C"

// ---------------------------------------------------------------------------
// glibc-compatible rand() and the reference's seeded square-id permutation
// (randomize_edgelist_square, edgelist.h:337-366: srand(5); rval[i] =
// rand() % m; sequential swap mapping[i] <-> mapping[rval[i]]).  The
// generator replicates glibc's TYPE_3 additive-feedback random()
// (31-word ring seeded via Park-Miller/Schrage, 310 warm-up outputs
// discarded) so the produced permutation is byte-identical to the
// reference binaries on the same input.

extern "C" {

void gm_glibc_square_mapping(int64_t m, uint32_t seed, int32_t* mapping) {
  uint32_t r[31];
  long long word = (seed == 0) ? 1 : (long long)seed;
  r[0] = (uint32_t)word;
  for (int i = 1; i < 31; ++i) {
    long long hi = word / 127773, lo = word % 127773;
    word = 16807 * lo - 2836 * hi;
    if (word < 0) word += 2147483647;
    r[i] = (uint32_t)word;
  }
  int f = 3, p = 0;
  for (int i = 0; i < 310; ++i) {
    r[f] += r[p];
    if (++f == 31) f = 0;
    if (++p == 31) p = 0;
  }
  std::vector<int64_t> rval(m);
  for (int64_t i = 0; i < m; ++i) {
    r[f] += r[p];
    rval[i] = (int64_t)((r[f] >> 1) % (uint32_t)m);
    if (++f == 31) f = 0;
    if (++p == 31) p = 0;
  }
  for (int64_t i = 0; i < m; ++i) mapping[i] = (int32_t)i;
  for (int64_t i = 0; i < m; ++i) {
    int64_t j = rval[i];
    int32_t tmp = mapping[i];
    mapping[i] = mapping[j];
    mapping[j] = tmp;
  }
}

}  // extern "C"

// ---------------------------------------------------------------------
// Triangle-counting v2 host prep: core-bitmap + tail-list split.
//
// Device formulation (ops/triangles.py): common neighbors are split at a
// degree-rank threshold.  Neighbors in the top-h "core" are intersected
// on device as packed uint32 bitmaps (AND + popcount over gathered
// rows); the remaining "tail" neighbors form short per-sender lists
// intersected by the broadcast-equality kernel.  Degree orientation
// closure (out-neighbors always have higher (deg, id) rank) makes the
// split exact: a core vertex has t_of == 0, so every hub-hub
// intersection rides the bitmap path.
//
// This function does everything the host needs in one native pass:
// dedup (optional), degree ranks, orientation, counting sort by sender,
// bitmap fill, tail-list extraction.  Reference analog: the tile
// build + GetNeighbors prep (src/TriangleCounting.cpp:82-111).
// ---------------------------------------------------------------------

namespace {

struct TcPrep {
  int64_t m = 0;    // oriented deduped edge count
  int64_t m2 = 0;   // tail-receiver edges (part-2 list entries)
  int32_t n = 0, h = 0, W = 0, ncr = 0, core_lo = 0;
  std::vector<int32_t> s, r;          // [m] grouped by sender
  std::vector<int64_t> off;           // [n+1] sender CSR offsets
  std::vector<int64_t> t2off;         // [n+1] tail-list offsets
  std::vector<int32_t> odeg, t_of, crow, rank_of;
};

}  // namespace

extern "C" {

// Phase 1.  assume_canonical != 0 promises the caller already passes
// unique undirected pairs with u < v (no self loops required — they are
// still dropped); the dedup sort is skipped entirely.
void* gm_tc_create(const int32_t* u, const int32_t* v, int64_t e,
                   int32_t n, int32_t h, int32_t assume_canonical,
                   int64_t* m_out, int64_t* m2_out, int32_t* ncr_out) {
  auto* p = new TcPrep();
  p->n = n;
  const int64_t N = n;
  std::vector<int64_t> key(e);
  {
    std::atomic<int64_t> nk{0};
#pragma omp parallel
    {
      std::vector<int64_t> local;
      local.reserve(e / (omp_get_max_threads() ? omp_get_max_threads()
                                               : 1) + 1);
#pragma omp for nowait
      for (int64_t i = 0; i < e; ++i) {
        if (u[i] == v[i]) continue;
        const int64_t a = std::min(u[i], v[i]);
        const int64_t b = std::max(u[i], v[i]);
        local.push_back(a * N + b);
      }
      const int64_t at = nk.fetch_add((int64_t)local.size());
      std::copy(local.begin(), local.end(), key.begin() + at);
    }
    key.resize(nk.load());
  }
  if (!assume_canonical) {
    __gnu_parallel::sort(key.begin(), key.end());
    key.erase(std::unique(key.begin(), key.end()), key.end());
  }
  const int64_t m = (int64_t)key.size();
  p->m = m;

  // degrees over the deduped undirected support
  std::vector<int32_t> deg(n, 0);
  for (int64_t i = 0; i < m; ++i) {
    ++deg[key[i] / N];
    ++deg[key[i] % N];
  }

  // degree ranks: rank_of[vtx] = position in (deg, id) ascending order
  p->rank_of.resize(n);
  {
    std::vector<int32_t> ord(n);
    for (int32_t i = 0; i < n; ++i) ord[i] = i;
    __gnu_parallel::sort(ord.begin(), ord.end(),
                         [&](int32_t a, int32_t b) {
                           return deg[a] < deg[b]
                                  || (deg[a] == deg[b] && a < b);
                         });
    for (int32_t i = 0; i < n; ++i) p->rank_of[ord[i]] = i;
  }

  // orient toward the (deg, id)-larger endpoint; histogram by sender
  p->odeg.assign(n, 0);
  p->s.resize(m);
  p->r.resize(m);
#pragma omp parallel
  {
    std::vector<int32_t> part(n, 0);
#pragma omp for
    for (int64_t i = 0; i < m; ++i) {
      const int32_t a = (int32_t)(key[i] / N);
      const int32_t b = (int32_t)(key[i] % N);
      const bool fwd = p->rank_of[a] < p->rank_of[b];
      p->s[i] = fwd ? a : b;   // temporarily unsorted
      p->r[i] = fwd ? b : a;
      ++part[p->s[i]];
    }
#pragma omp critical
    for (int32_t x = 0; x < n; ++x) p->odeg[x] += part[x];
  }

  // counting sort by sender (receiver order within a sender is free)
  p->off.assign(n + 1, 0);
  for (int32_t x = 0; x < n; ++x) p->off[x + 1] = p->off[x] + p->odeg[x];
  {
    std::vector<int32_t> ss(m), rr(m);
    std::vector<int64_t> cur(p->off.begin(), p->off.end() - 1);
    for (int64_t i = 0; i < m; ++i) {
      const int64_t at = cur[p->s[i]]++;
      ss[at] = p->s[i];
      rr[at] = p->r[i];
    }
    p->s.swap(ss);
    p->r.swap(rr);
  }

  // core split
  p->h = std::min<int32_t>(h, n);
  p->core_lo = n - p->h;
  p->W = (p->h + 31) / 32;
  p->t_of.assign(n, 0);
  std::atomic<int64_t> m2{0};
#pragma omp parallel for schedule(dynamic, 4096)
  for (int32_t x = 0; x < n; ++x) {
    int32_t t = 0;
    for (int64_t i = p->off[x]; i < p->off[x + 1]; ++i)
      if (p->rank_of[p->r[i]] < p->core_lo) ++t;
    p->t_of[x] = t;
    if (t) m2.fetch_add(t);
  }
  p->m2 = m2.load();
  p->t2off.assign(n + 1, 0);
  for (int32_t x = 0; x < n; ++x)
    p->t2off[x + 1] = p->t2off[x] + p->t_of[x];

  // compressed bitmap rows: only senders with >= 1 core out-neighbor
  p->crow.assign(n, -1);
  int32_t ncr = 0;
  for (int32_t x = 0; x < n; ++x)
    if (p->odeg[x] - p->t_of[x] > 0) p->crow[x] = ncr++;
  p->ncr = ncr;

  *m_out = p->m;
  *m2_out = p->m2;
  *ncr_out = ncr;
  return p;
}

// Phase 2.  Caller allocates:
//   s_all, r_all, iu_row, iv_row : int32 [m]
//   bitmap                       : uint32 [(ncr+1) * W], ZERO-initialized
//   s2, r2, t2rank               : int32 [m2]
//   t_of_out, odeg_out           : int32 [n]
void gm_tc_fill(void* handle, int32_t* s_all, int32_t* r_all,
                int32_t* iu_row, int32_t* iv_row, uint32_t* bitmap,
                int32_t* s2, int32_t* r2, int32_t* t2rank,
                int32_t* t_of_out, int32_t* odeg_out) {
  auto* p = static_cast<TcPrep*>(handle);
  const int32_t n = p->n, W = p->W, ncr = p->ncr, core_lo = p->core_lo;
#pragma omp parallel for schedule(dynamic, 2048)
  for (int32_t x = 0; x < n; ++x) {
    const int32_t cu = p->crow[x] < 0 ? ncr : p->crow[x];
    int32_t trk = 0;
    int64_t t2 = p->t2off[x];
    for (int64_t i = p->off[x]; i < p->off[x + 1]; ++i) {
      const int32_t rv = p->r[i];
      const int32_t rk = p->rank_of[rv];
      s_all[i] = x;
      r_all[i] = rv;
      iu_row[i] = cu;
      iv_row[i] = p->crow[rv] < 0 ? ncr : p->crow[rv];
      if (rk >= core_lo) {
        const int32_t bit = rk - core_lo;
        bitmap[(int64_t)p->crow[x] * W + (bit >> 5)] |= 1u << (bit & 31);
      } else {
        s2[t2] = x;
        r2[t2] = rv;
        t2rank[t2] = trk++;
        ++t2;
      }
    }
  }
  std::memcpy(t_of_out, p->t_of.data(), (size_t)n * sizeof(int32_t));
  std::memcpy(odeg_out, p->odeg.data(), (size_t)n * sizeof(int32_t));
}

void gm_tc_destroy(void* handle) { delete static_cast<TcPrep*>(handle); }

}  // extern "C"
