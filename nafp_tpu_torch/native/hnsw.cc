// HNSW (Hierarchical Navigable Small World) approximate-NN index.
//
// Native CPU counterpart of the reference's faiss.IndexHNSWFlat option
// (eval/utils/get_index_faiss.py:88-96: M=16, efConstruction=80, CPU-only).
// Graph search is pointer-chasing, so like the reference this index is
// host-side; it exists for API parity and for serving deployments that want
// sub-millisecond single-query latency without a device round-trip. This
// file is the JAX package's nafp_tpu/native/hnsw.cc, copied unchanged below
// this header so the PyTorch port builds its own library.
//
// Implementation: Malkov & Yashunin 2016 (arXiv:1603.09320). Inner-product
// "distance" (fingerprints are L2-normalized): we maximize q·x, stored
// internally as negated scores so the algorithm stays min-heap shaped.
//
// C ABI:
//   hnsw_create(d, M, ef_construction, seed) -> handle
//   hnsw_add(handle, data, n)                   (bulk insert, serial)
//   hnsw_add_parallel(handle, data, n, n_threads)  (bulk insert, threaded)
//   hnsw_search(handle, queries, nq, k, ef_search, out_ids, out_scores)
//   hnsw_save(handle, path) -> 0/err; hnsw_load(path) -> handle|NULL
//   hnsw_size(handle) -> n
//   hnsw_free(handle)

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <random>
#include <thread>
#include <vector>

namespace {

// striped per-node locks for the threaded bulk add (std::mutex is neither
// movable nor resizable in a vector; a fixed stripe pool sidesteps that)
constexpr int kLockStripes = 4096;

struct Hnsw {
  int d;
  int M;            // max links per node per layer (2M at layer 0)
  int ef_c;         // efConstruction
  double level_mult;
  // Level sampling is the deterministic per-id splitmix hash (sample_level)
  // -- no RNG stream, which is what makes the parallel add order-invariant.
  uint64_t seed = 0;

  std::vector<float> data;                       // n * d
  std::vector<int> levels;                       // per node
  // links[l][node] = neighbor ids (flat per layer, capped)
  std::vector<std::vector<std::vector<int>>> links;
  int entry = -1;
  int max_level = -1;

  std::mutex stripes[kLockStripes];              // node -> stripes[id % k]
  std::mutex global_mu;                          // entry / max_level

  int n() const { return static_cast<int>(levels.size()); }

  float ip(const float* a, const float* b) const {
    float s = 0.f;
    for (int i = 0; i < d; ++i) s += a[i] * b[i];
    return s;
  }
  float dist(const float* q, int id) const {  // smaller = better
    return -ip(q, data.data() + static_cast<int64_t>(id) * d);
  }
};

using PQ = std::priority_queue<std::pair<float, int>>;  // max-heap on dist

// Greedy beam search at one layer. Returns up to ef closest (dist, id),
// as a max-heap so the worst is on top. With locked=true every neighbor
// list is copied under its node's stripe lock (the threaded bulk add
// mutates lists concurrently; searches against a quiescent graph skip the
// locks entirely).
template <bool locked>
PQ search_layer(Hnsw& h, const float* q, int enter, int ef, int layer,
                std::vector<uint8_t>& visited, std::vector<int>& touched) {
  PQ best;                                             // worst on top
  std::priority_queue<std::pair<float, int>,
                      std::vector<std::pair<float, int>>,
                      std::greater<>> cand;            // closest on top
  float d0 = h.dist(q, enter);
  best.emplace(d0, enter);
  cand.emplace(d0, enter);
  visited[enter] = 1;
  touched.push_back(enter);
  std::vector<int> nbs_copy;

  while (!cand.empty()) {
    auto [dc, c] = cand.top();
    if (dc > best.top().first && static_cast<int>(best.size()) >= ef) break;
    cand.pop();
    const std::vector<int>* nbs = &h.links[layer][c];
    if (locked) {
      std::lock_guard<std::mutex> g(h.stripes[c % kLockStripes]);
      nbs_copy = h.links[layer][c];
      nbs = &nbs_copy;
    }
    for (int nb : *nbs) {
      if (visited[nb]) continue;
      visited[nb] = 1;
      touched.push_back(nb);
      float dn = h.dist(q, nb);
      if (static_cast<int>(best.size()) < ef || dn < best.top().first) {
        best.emplace(dn, nb);
        cand.emplace(dn, nb);
        if (static_cast<int>(best.size()) > ef) best.pop();
      }
    }
  }
  return best;
}

// Simple neighbor selection: keep the M closest (used for query results).
std::vector<int> select_neighbors(PQ best, int m) {
  std::vector<std::pair<float, int>> all;
  while (!best.empty()) {
    all.push_back(best.top());
    best.pop();
  }
  std::sort(all.begin(), all.end());
  std::vector<int> out;
  for (int i = 0; i < static_cast<int>(all.size()) && i < m; ++i)
    out.push_back(all[i].second);
  return out;
}

// Heuristic neighbor selection (Malkov & Yashunin Alg. 4) for GRAPH edges:
// scan candidates closest-first and keep c only if it is closer to the
// query point than to every already-kept neighbor — this prunes edges that
// merely re-cover one dense direction and keeps edges that bridge distinct
// regions, which is what gives HNSW its navigability (plain keep-M-closest
// built graphs that measured recall@20 0.69 @ 500k; the heuristic is the
// known fix). keep_pruned (Alg. 4's keepPrunedConnections) fills remaining
// slots with the closest pruned candidates so the NEW node keeps full
// degree; back-link shrinks pass false (as hnswlib/faiss do) so pruned
// lists settle below capacity instead of re-shrinking on every insert.
std::vector<int> select_neighbors_heuristic(const Hnsw& h, const float* q,
                                            PQ best, int m,
                                            bool keep_pruned) {
  std::vector<std::pair<float, int>> all;
  while (!best.empty()) {
    all.push_back(best.top());
    best.pop();
  }
  std::sort(all.begin(), all.end());  // closest first
  std::vector<int> out;
  std::vector<int> pruned;
  for (const auto& [dc, c] : all) {
    if (static_cast<int>(out.size()) >= m) break;
    const float* cv = h.data.data() + static_cast<int64_t>(c) * h.d;
    bool diverse = true;
    for (int s : out) {
      if (h.dist(cv, s) < dc) {  // c is closer to a kept neighbor than to q
        diverse = false;
        break;
      }
    }
    if (diverse) {
      out.push_back(c);
    } else if (keep_pruned) {
      pruned.push_back(c);
    }
  }
  if (keep_pruned) {
    for (int c : pruned) {
      if (static_cast<int>(out.size()) >= m) break;
      out.push_back(c);
    }
  }
  return out;
}

// splitmix64: deterministic per-id level hash, so a node's level does not
// depend on insert order or thread interleaving (serial and threaded bulk
// adds sample the same level structure).
uint64_t mix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ULL;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
  return x ^ (x >> 31);
}

int sample_level(const Hnsw& h, int id) {
  double u = (mix64(h.seed ^ static_cast<uint64_t>(id + 1)) >> 11) *
             (1.0 / 9007199254740992.0);                 // [0, 1)
  return static_cast<int>(-std::log(std::max(1.0 - u, 1e-12)) *
                          h.level_mult);
}

template <bool locked>
void insert(Hnsw& h, int id, std::vector<uint8_t>& visited,
            std::vector<int>& touched) {
  int level = sample_level(h, id);
  h.levels[id] = level;

  const float* q = h.data.data() + static_cast<int64_t>(id) * h.d;
  int entry, max_level;
  {
    std::unique_lock<std::mutex> g(h.global_mu, std::defer_lock);
    if (locked) g.lock();
    if (h.entry < 0) {
      h.entry = id;
      h.max_level = level;
      return;
    }
    entry = h.entry;
    max_level = h.max_level;
  }

  int cur = entry;
  std::vector<int> nbs_copy;
  // greedy descend through layers above `level`
  for (int l = max_level; l > level; --l) {
    bool moved = true;
    while (moved) {
      moved = false;
      const std::vector<int>* nbs = &h.links[l][cur];
      if (locked) {
        std::lock_guard<std::mutex> g(h.stripes[cur % kLockStripes]);
        nbs_copy = h.links[l][cur];
        nbs = &nbs_copy;
      }
      for (int nb : *nbs) {
        if (h.dist(q, nb) < h.dist(q, cur)) {
          cur = nb;
          moved = true;
        }
      }
    }
  }
  // insert with beam search from min(level, max_level) down to 0
  for (int l = std::min(level, max_level); l >= 0; --l) {
    for (int t : touched) visited[t] = 0;
    touched.clear();
    PQ best = search_layer<locked>(h, q, cur, h.ef_c, l, visited, touched);
    int m = (l == 0) ? 2 * h.M : h.M;
    auto nbs = select_neighbors_heuristic(h, q, std::move(best), m,
                                          /*keep_pruned=*/true);
    {
      // publish our own list BEFORE back-links make id reachable
      std::unique_lock<std::mutex> g(h.stripes[id % kLockStripes],
                                     std::defer_lock);
      if (locked) g.lock();
      h.links[l][id] = nbs;
    }
    if (!nbs.empty()) cur = nbs[0];
    for (int nb : nbs) {
      std::unique_lock<std::mutex> g(h.stripes[nb % kLockStripes],
                                     std::defer_lock);
      if (locked) g.lock();
      auto& back = h.links[l][nb];
      back.push_back(id);
      // Amortized shrink: let lists overshoot to 1.5*m before pruning back
      // to m. On distributions where the diversity heuristic rarely fires
      // (e.g. near-IID vectors, where candidates are mutually orthogonal)
      // a shrink-at-m policy re-runs the O(m^2)-dot heuristic on EVERY
      // back-link — ~30k dots/insert, 10x the beam cost. The slack cuts
      // shrink frequency ~m/2-fold; searches just scan the slightly longer
      // lists (bounded degree 1.5*m), which only helps recall.
      if (static_cast<int>(back.size()) > m + m / 2) {
        // shrink with the diversity heuristic, no refill (see above)
        const float* nbv = h.data.data() + static_cast<int64_t>(nb) * h.d;
        PQ cand;
        for (int x : back) cand.emplace(h.dist(nbv, x), x);
        back = select_neighbors_heuristic(h, nbv, std::move(cand), m,
                                          /*keep_pruned=*/false);
      }
    }
  }
  {
    std::unique_lock<std::mutex> g(h.global_mu, std::defer_lock);
    if (locked) g.lock();
    if (level > h.max_level) {
      h.max_level = level;
      h.entry = id;
    }
  }
}

}  // namespace

extern "C" {

void* hnsw_create(int d, int M, int ef_construction, uint64_t seed) {
  auto* h = new Hnsw();
  h->d = d;
  h->M = M;
  h->ef_c = ef_construction;
  h->level_mult = 1.0 / std::log(std::max(2, M));
  h->seed = seed;
  h->links.resize(64);  // max levels; geometric makes >40 impossible
  return h;
}

void grow(Hnsw& h, const float* data, int n) {
  int start = h.n();
  int total = start + n;
  h.data.resize(static_cast<int64_t>(total) * h.d);
  memcpy(h.data.data() + static_cast<int64_t>(start) * h.d, data,
         sizeof(float) * static_cast<int64_t>(n) * h.d);
  h.levels.resize(total, 0);
  // Size only the layers any node can touch. Levels are a pure per-id
  // hash (sample_level), so the deepest layer is known BEFORE any insert
  // runs — including under the threaded add, where resizing a layer
  // mid-insert would race. Sizing all 64 preallocated layers costs
  // 64 * n empty vector headers (24 B each): ~768 MB at 500 k rows,
  // ~82 GB at 53.6 M — for ~log_M(n) <= ~5 populated layers.
  int needed = std::max(h.max_level, 0);
  for (int id = start; id < total; ++id)
    needed = std::max(needed, sample_level(h, id));
  for (int l = 0; l <= needed; ++l) h.links[l].resize(total);
}

void hnsw_add(void* handle, const float* data, int n) {
  auto* h = static_cast<Hnsw*>(handle);
  int start = h->n();
  grow(*h, data, n);
  int total = h->n();
  std::vector<uint8_t> visited(total, 0);
  std::vector<int> touched;
  touched.reserve(4096);
  for (int id = start; id < total; ++id) {
    for (int t : touched) visited[t] = 0;
    touched.clear();
    insert<false>(*h, id, visited, touched);
  }
}

// Threaded bulk insert (the faiss/hnswlib pattern): per-node striped locks
// guard every link-list read/write; entry/max_level under a global mutex;
// levels are a pure per-id hash so the level structure is independent of
// thread interleaving. The first node goes in serially so every thread has
// an entry point. NOTE: this host has one core (the serial path is the
// measured one); the threaded path exists for multi-core deployments and
// is raced-checked under ThreadSanitizer in tests/test_hnsw.py.
void hnsw_add_parallel(void* handle, const float* data, int n,
                       int n_threads) {
  auto* h = static_cast<Hnsw*>(handle);
  int start = h->n();
  grow(*h, data, n);
  int total = h->n();
  if (n_threads <= 0)
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
  n_threads = std::max(1, std::min(n_threads, n));

  int first = start;
  if (h->entry < 0 && n > 0) {   // seed the graph before threads start
    std::vector<uint8_t> visited(total, 0);
    std::vector<int> touched;
    insert<false>(*h, start, visited, touched);
    first = start + 1;
  }
  std::atomic<int> next(first);
  auto worker = [&]() {
    std::vector<uint8_t> visited(total, 0);
    std::vector<int> touched;
    touched.reserve(4096);
    for (;;) {
      int id = next.fetch_add(1);
      if (id >= total) break;
      for (int t : touched) visited[t] = 0;
      touched.clear();
      insert<true>(*h, id, visited, touched);
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
}

int hnsw_size(void* handle) { return static_cast<Hnsw*>(handle)->n(); }

int hnsw_dim(void* handle) { return static_cast<Hnsw*>(handle)->d; }

// ---- persistence ----------------------------------------------------------
// Binary layout: magic, version, {d, M, ef_c, entry, max_level}, seed, n,
// levels[n], data[n*d], then per layer 0..max_level per node: count + ids.
// (faiss's IndexHNSWFlat has write_index/read_index; the reference never
// persisted its index — every eval retrained, eval_faiss.py:141-151.)
constexpr uint64_t kMagic = 0x4e41465048534e57ULL;  // "NAFPHSNW"

int hnsw_save(void* handle, const char* path) {
  auto* h = static_cast<Hnsw*>(handle);
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  auto w = [&](const void* p, size_t sz) {
    return fwrite(p, 1, sz, f) == sz;
  };
  uint32_t version = 1;
  int64_t n = h->n();
  int32_t hdr[5] = {h->d, h->M, h->ef_c, h->entry, h->max_level};
  bool ok = w(&kMagic, 8) && w(&version, 4) && w(hdr, sizeof hdr) &&
            w(&h->seed, 8) && w(&n, 8) &&
            w(h->levels.data(), n * sizeof(int)) &&
            w(h->data.data(), n * h->d * sizeof(float));
  for (int l = 0; ok && l <= std::max(h->max_level, 0); ++l) {
    for (int64_t i = 0; ok && i < n; ++i) {
      const auto& nbs = h->links[l][i];
      int32_t cnt = static_cast<int32_t>(nbs.size());
      ok = w(&cnt, 4) && (cnt == 0 || w(nbs.data(), cnt * sizeof(int)));
    }
  }
  if (fclose(f) != 0) ok = false;
  return ok ? 0 : -2;
}

void* hnsw_load(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  auto r = [&](void* p, size_t sz) { return fread(p, 1, sz, f) == sz; };
  uint64_t magic;
  uint32_t version;
  int32_t hdr[5];
  uint64_t seed;
  int64_t n;
  if (!(r(&magic, 8) && magic == kMagic && r(&version, 4) && version == 1 &&
        r(hdr, sizeof hdr) && r(&seed, 8) && r(&n, 8))) {
    fclose(f);
    return nullptr;
  }
  // header sanity: a corrupted file that passes the magic check must not
  // index out of bounds (entry/max_level bound every later array access)
  if (hdr[0] <= 0 || hdr[1] <= 0 || n < 0 || hdr[4] >= 64 ||
      hdr[3] < -1 || hdr[3] >= n) {
    fclose(f);
    return nullptr;
  }
  // Bound n by what the file can actually hold (levels: 4 B/node, data:
  // 4*d B/node must follow the header): a corrupt/crafted n would
  // otherwise drive multi-GB resizes whose bad_alloc (or n*d overflow)
  // escapes the extern "C" boundary and aborts the process instead of
  // returning the designed nullptr.
  long hdr_end = ftell(f);
  if (hdr_end < 0 || fseek(f, 0, SEEK_END) != 0) { fclose(f); return nullptr; }
  long fsz = ftell(f);
  if (fsz < hdr_end || fseek(f, hdr_end, SEEK_SET) != 0) {
    fclose(f);
    return nullptr;
  }
  int64_t per_node = 4 + 4 * static_cast<int64_t>(hdr[0]);
  if (n > (fsz - hdr_end) / per_node) {
    fclose(f);
    return nullptr;
  }
  auto* h = static_cast<Hnsw*>(hnsw_create(hdr[0], hdr[1], hdr[2], seed));
  h->entry = hdr[3];
  h->max_level = hdr[4];
  h->levels.resize(n);
  h->data.resize(n * h->d);
  for (int l = 0; l <= std::max(h->max_level, 0); ++l) h->links[l].resize(n);
  bool ok = r(h->levels.data(), n * sizeof(int)) &&
            r(h->data.data(), n * h->d * sizeof(float));
  for (int l = 0; ok && l <= std::max(h->max_level, 0); ++l) {
    for (int64_t i = 0; ok && i < n; ++i) {
      int32_t cnt = 0;
      ok = r(&cnt, 4) && cnt >= 0 && cnt <= n;
      if (ok && cnt) {
        h->links[l][i].resize(cnt);
        ok = r(h->links[l][i].data(), cnt * sizeof(int));
        // neighbor ids feed unchecked data/visited indexing at search
        // time; reject any id outside [0, n) here instead of segfaulting
        // there (bit rot, truncated/overwritten store)
        for (int32_t j = 0; ok && j < cnt; ++j) {
          int nb = h->links[l][i][j];
          ok = nb >= 0 && nb < n;
        }
      }
    }
  }
  fclose(f);
  if (!ok) {
    delete h;
    return nullptr;
  }
  return h;
}

void hnsw_search(void* handle, const float* queries, int nq, int k,
                 int ef_search, int64_t* out_ids, float* out_scores) {
  auto* h = static_cast<Hnsw*>(handle);
  if (h->entry < 0) {  // empty index: report misses, don't crash
    for (int64_t i = 0; i < static_cast<int64_t>(nq) * k; ++i) {
      out_ids[i] = -1;
      out_scores[i] = -1e30f;
    }
    return;
  }
  std::vector<uint8_t> visited(h->n(), 0);
  std::vector<int> touched;
  touched.reserve(4096);
  for (int qi = 0; qi < nq; ++qi) {
    const float* q = queries + static_cast<int64_t>(qi) * h->d;
    int cur = h->entry;
    for (int l = h->max_level; l > 0; --l) {
      bool moved = true;
      while (moved) {
        moved = false;
        for (int nb : h->links[l][cur]) {
          if (h->dist(q, nb) < h->dist(q, cur)) {
            cur = nb;
            moved = true;
          }
        }
      }
    }
    for (int t : touched) visited[t] = 0;
    touched.clear();
    PQ best = search_layer<false>(*h, q, cur, std::max(ef_search, k), 0,
                                  visited, touched);
    auto nbs = select_neighbors(std::move(best), k);
    for (int i = 0; i < k; ++i) {
      if (i < static_cast<int>(nbs.size())) {
        out_ids[qi * k + i] = nbs[i];
        out_scores[qi * k + i] =
            h->ip(q, h->data.data() + static_cast<int64_t>(nbs[i]) * h->d);
      } else {
        out_ids[qi * k + i] = -1;
        out_scores[qi * k + i] = -1e30f;
      }
    }
  }
}

void hnsw_free(void* handle) { delete static_cast<Hnsw*>(handle); }

}  // extern "C"

// Race-check harness: compiled into a standalone binary by the test suite
// with -fsanitize=thread (TSan cannot instrument a .so loaded into an
// uninstrumented Python). Builds a small index with the threaded bulk add
// and runs a few searches; any data race aborts with a TSan report.
#ifdef HNSW_TSAN_MAIN
#include <cstdlib>
int main() {
  const int n = 3000, d = 32, nq = 16, k = 5;
  std::vector<float> data(static_cast<size_t>(n) * d);
  std::mt19937 rng(7);
  std::normal_distribution<float> g;
  for (auto& x : data) x = g(rng);
  void* h = hnsw_create(d, 8, 40, 0);
  hnsw_add_parallel(h, data.data(), n, 4);
  if (hnsw_size(h) != n) return 2;
  std::vector<int64_t> ids(nq * k);
  std::vector<float> scores(nq * k);
  hnsw_search(h, data.data(), nq, k, 64, ids.data(), scores.data());
  int hits = 0;
  for (int i = 0; i < nq; ++i)
    for (int j = 0; j < k; ++j) hits += ids[i * k + j] == i;
  hnsw_free(h);
  // every query IS a db row: the graph must find most of them exactly
  return hits >= nq * 9 / 10 ? 0 : 3;
}
#endif
