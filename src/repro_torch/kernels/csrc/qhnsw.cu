// qhnsw: the deterministic HNSW graph's search and insert on the card, for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel. The reference runs this work in jnp under
// jit (src/repro/core/hnsw.py: greedy_step_level, search_layer,
// hnsw_insert, hnsw_search; machine._apply_insert_segment and relink scan
// hnsw_insert, query.batched_hnsw_search vmaps hnsw_search). A beam whose
// every step depends on the distances of the last has no PyTorch call that
// runs without a host round trip per step, so the beams are written here
// by hand. The plain version is kernels/qhnsw/ref.py (the host-driven
// beams); every decision below follows it:
//
//   * a distance is sum((int64 row - int64 query)^2) with int64 wrapping
//     (uint64 arithmetic here: C++ leaves signed overflow undefined);
//   * every order is (int64 distance, int32 slot) lexicographic, the fast
//     construction beam's (distance, slot, expanded);
//   * INF = 2^62, PAD = 2^31 - 1; _sort_dedup blanks an adjacent repeat of
//     a slot to (INF, PAD) and sorts again;
//   * a beam stops after 2 ef + 8 expansions, a greedy walk after capacity
//     steps; the default beam's seen set takes the reference's scatter
//     (marks from the old set, the last write to a slot wins).
//
// qhnsw_search: one CTA per (query, shard). Greedy descent from the entry
// at the upper levels, then the level-0 ef-beam that ranks tombstones by
// their stored rows (dead_ok), dead rows dropped from the answer, the
// (distance, slot) sort and the cut to min(k, ef).
// qhnsw_insert: one CTA per shard; it links the shard's list of stored
// slots into its graph in order (level from splitmix64 of the id capped by
// the entry's, the first node the entry, greedy descent, the
// ef_construction beam at each level, forward edges to the m nearest,
// each reverse row pruned to the degree by (distance to its owner, slot)),
// the fast or the default variant. The graph stays on the card.
//
// Work per CTA: the query row (as int64), the beam and its merge buffer,
// the candidates, the reverse rows being pruned and the seen / expanded
// bitmaps (one bit per row of the shard) live in dynamic shared memory;
// what does not fit in a block's 227 KB goes to the CTA's slice of a
// global scratch. The block's 16 warps split each expansion's degree rows
// (one row's distance per warp, lanes over the dimension, a shuffle sum);
// sorts are rank counts (each element's position by comparing it with the
// rest of its list), in parallel over the block; the few sequential steps
// (the pick of the next node, the seen-set scatter) run on one thread.
//
// What bounds it: neither the bytes nor the operations. A beam is a chain
// of dependent steps, each reading degree rows (16 x 9216 bytes at d =
// 2304), and an insert is a chain of beams; the time is the chain's
// latency, and a flat insert run has one CTA. That is the simple design;
// CTAs cooperating on one insert (clusters), TMA row loads or batched
// inserts are for later.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kInf = 1ll << 62;
constexpr int32_t kPad = 0x7fffffff;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// dynamic shared memory a block may hold: 227 KB less the static scalars
constexpr int64_t kSmemMax = 232448 - 1024;

// the argument array shared with kernels/qhnsw/kernel.py (ARGS there)
enum Arg {
  A_OP, A_ELEM, A_NS, A_CAP, A_DIM, A_DEGREE, A_LEVELS,
  A_VEC, A_VEC_SS, A_IDS, A_VALID, A_LVL, A_ROW_SS,
  A_NBR, A_NBR_SS, A_NBR_LS, A_ENTRY,
  A_EF, A_MAX_ITERS,
  A_Q, A_B, A_KK, A_OUT_IDS, A_OUT_D, A_OUT_S,
  A_SLOTS, A_SLOTS_STRIDE, A_N_REAL, A_M, A_FAST,
  A_SCRATCH, A_COUNT
};

// workspace buffers, in the order they are offered shared memory
enum Buf {
  B_Q, B_BD, B_BS, B_BF, B_TD, B_TS, B_TF, B_ROW, B_FRESH, B_MARK,
  B_CD, B_CS, B_OWN, B_CUR, B_SEEN, B_EXP, B_COUNT
};

struct Args {  // passed by value: a kernel's parameters hold 4 KB
  int64_t v[A_COUNT];
};

struct Layout {
  int64_t off[B_COUNT];
  int in_smem[B_COUNT];
  int64_t smem, gmem;  // bytes per CTA
};

struct Work {
  long long* q;
  long long* bd;
  int32_t* bs;
  uint8_t* bf;
  long long* td;
  int32_t* ts;
  uint8_t* tf;
  int32_t* row;
  uint8_t* fresh;
  uint8_t* mark;
  long long* cd;
  int32_t* cs;
  int32_t* own;
  int32_t* cur;
  uint32_t* seen;
  uint32_t* exp;
};

struct Scal {  // block-wide scalars, written by thread 0
  long long cur_d;
  long long d0;
  int32_t cur;
  int32_t entry;
  int moved;
  int pick;
  int any;
  int n_own;
};

int64_t align16(int64_t x) { return (x + 15) & ~int64_t(15); }

Layout make_layout(const int64_t* a) {
  const int64_t op = a[A_OP], cap = a[A_CAP], dim = a[A_DIM];
  const int64_t deg = a[A_DEGREE], ef = a[A_EF];
  const int64_t m = op == 1 ? a[A_M] : 0;
  const int64_t mm = m < ef ? m : ef;
  const bool need_exp = op == 0 || a[A_FAST] == 0;
  int64_t nmax = ef + deg;
  if (mm * (deg + 1) > nmax) nmax = mm * (deg + 1);
  const int64_t words = (cap + 31) / 32;
  int64_t size[B_COUNT] = {
      dim * 8, nmax * 8, nmax * 4, nmax, nmax * 8, nmax * 4, nmax,
      deg * 4, deg, deg,
      op == 1 ? ef * 8 : 0, op == 1 ? ef * 4 : 0,
      mm * 4, mm * deg * 4,
      words * 4, need_exp ? words * 4 : 0};
  Layout L;
  L.smem = 0;
  L.gmem = 0;
  for (int b = 0; b < B_COUNT; ++b) {
    const int64_t s = align16(size[b]);
    if (L.smem + s <= kSmemMax) {
      L.in_smem[b] = 1;
      L.off[b] = L.smem;
      L.smem += s;
    } else {
      L.in_smem[b] = 0;
      L.off[b] = L.gmem;
      L.gmem += s;
    }
  }
  return L;
}

__device__ Work bind_work(const Layout& L, uint8_t* smem, uint8_t* gmem) {
  void* p[B_COUNT];
  for (int b = 0; b < B_COUNT; ++b)
    p[b] = (L.in_smem[b] ? smem : gmem) + L.off[b];
  Work w;
  w.q = static_cast<long long*>(p[B_Q]);
  w.bd = static_cast<long long*>(p[B_BD]);
  w.bs = static_cast<int32_t*>(p[B_BS]);
  w.bf = static_cast<uint8_t*>(p[B_BF]);
  w.td = static_cast<long long*>(p[B_TD]);
  w.ts = static_cast<int32_t*>(p[B_TS]);
  w.tf = static_cast<uint8_t*>(p[B_TF]);
  w.row = static_cast<int32_t*>(p[B_ROW]);
  w.fresh = static_cast<uint8_t*>(p[B_FRESH]);
  w.mark = static_cast<uint8_t*>(p[B_MARK]);
  w.cd = static_cast<long long*>(p[B_CD]);
  w.cs = static_cast<int32_t*>(p[B_CS]);
  w.own = static_cast<int32_t*>(p[B_OWN]);
  w.cur = static_cast<int32_t*>(p[B_CUR]);
  w.seen = static_cast<uint32_t*>(p[B_SEEN]);
  w.exp = static_cast<uint32_t*>(p[B_EXP]);
  return w;
}

// one shard's graph
template <typename T>
struct Graph {
  const T* vec;
  const long long* ids;
  const uint8_t* valid;
  int32_t* nbr;
  int32_t* levels;
  int64_t lvl_stride;
  int32_t cap;
  int dim, degree, max_levels;

  __device__ int32_t clip(int64_t x) const {
    return x < 0 ? 0 : (x >= cap ? cap - 1 : static_cast<int32_t>(x));
  }
  __device__ int32_t* row(int lvl, int32_t slot) const {
    return nbr + lvl * lvl_stride + static_cast<int64_t>(slot) * degree;
  }
  __device__ const T* vrow(int32_t slot) const {
    return vec + static_cast<int64_t>(slot) * dim;
  }
};

template <typename T>
__device__ Graph<T> graph_of(const int64_t* a, int s) {
  Graph<T> g;
  g.vec = reinterpret_cast<const T*>(a[A_VEC]) + s * a[A_VEC_SS];
  g.ids = reinterpret_cast<const long long*>(a[A_IDS]) + s * a[A_ROW_SS];
  g.valid = reinterpret_cast<const uint8_t*>(a[A_VALID]) + s * a[A_ROW_SS];
  g.levels = reinterpret_cast<int32_t*>(a[A_LVL]) + s * a[A_ROW_SS];
  g.nbr = reinterpret_cast<int32_t*>(a[A_NBR]) + s * a[A_NBR_SS];
  g.lvl_stride = a[A_NBR_LS];
  g.cap = static_cast<int32_t>(a[A_CAP]);
  g.dim = static_cast<int>(a[A_DIM]);
  g.degree = static_cast<int>(a[A_DEGREE]);
  g.max_levels = static_cast<int>(a[A_LEVELS]);
  return g;
}

__device__ __forceinline__ bool bit(const uint32_t* m, int32_t x) {
  return (m[x >> 5] >> (x & 31)) & 1u;
}
__device__ __forceinline__ void set_bit(uint32_t* m, int32_t x, bool v) {
  if (v)
    m[x >> 5] |= 1u << (x & 31);
  else
    m[x >> 5] &= ~(1u << (x & 31));
}

// sum over the row of (row - q)^2, wrapping as int64 does; warp-wide
template <typename T>
__device__ __forceinline__ long long dist_q(const T* row, const long long* q,
                                            int dim, int lane) {
  u64 acc = 0;
#pragma unroll 4
  for (int j = lane; j < dim; j += 32) {
    const u64 x = static_cast<u64>(static_cast<long long>(__ldg(row + j))) -
                  static_cast<u64>(q[j]);
    acc += x * x;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
  return static_cast<long long>(acc);
}

template <typename T>
__device__ __forceinline__ long long dist_rows(const T* a, const T* b, int dim,
                                               int lane) {
  u64 acc = 0;
#pragma unroll 4
  for (int j = lane; j < dim; j += 32) {
    const u64 x = static_cast<u64>(static_cast<long long>(__ldg(a + j))) -
                  static_cast<u64>(static_cast<long long>(__ldg(b + j)));
    acc += x * x;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
  return static_cast<long long>(acc);
}

enum Mode { kMasked, kTraverse };

// out[i] = distance from q to slots[i] (for the i with want[i], when want
// is given; the rest INF): kMasked is _wide_l2 (-1 and invalid rows INF),
// kTraverse _wide_l2_traverse (-1 INF). One warp per slot. Ends synced.
template <typename T>
__device__ void dists_to(const Graph<T>& g, const long long* q,
                         const int32_t* slots, const uint8_t* want, int n,
                         Mode mode, long long* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < n; i += kWarps) {
    const int32_t x = slots[i];
    bool ok = (want == nullptr || want[i]) && x >= 0;
    if (ok && mode == kMasked) ok = g.valid[g.clip(x)] != 0;
    long long r = kInf;
    if (ok) r = dist_q(g.vrow(g.clip(x)), q, g.dim, lane);
    if (lane == 0) out[i] = r;
  }
  __syncthreads();
}

__device__ __forceinline__ bool key_less(long long da, int32_t sa, uint8_t fa,
                                         long long db, int32_t sb, uint8_t fb) {
  if (da != db) return da < db;
  if (sa != sb) return sa < sb;
  return fa < fb;
}

// sort each list of ``seg`` entries of (d, s[, f]) in place by rank
// counting; equal keys keep their order. Ends synced.
__device__ void block_sort(long long* d, int32_t* s, uint8_t* f, int n,
                           int seg, long long* td, int32_t* ts, uint8_t* tf) {
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int base = (i / seg) * seg;
    const long long di = d[i];
    const int32_t si = s[i];
    const uint8_t fi = f ? f[i] : 0;
    int rank = 0;
    for (int j = base; j < base + seg; ++j) {
      const long long dj = d[j];
      const int32_t sj = s[j];
      const uint8_t fj = f ? f[j] : 0;
      const bool lt = key_less(dj, sj, fj, di, si, fi);
      const bool eq = dj == di && sj == si && fj == fi;
      rank += lt || (eq && j < i);
    }
    td[base + rank] = di;
    ts[base + rank] = si;
    if (f) tf[base + rank] = fi;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    d[i] = td[i];
    s[i] = ts[i];
    if (f) f[i] = tf[i];
  }
  __syncthreads();
}

// _sort_dedup on each list of ``seg``: sort, blank a slot equal to the one
// before it (not PAD) to (INF, PAD), sort again where anything was blanked
__device__ void block_sort_dedup(long long* d, int32_t* s, int n, int seg,
                                 long long* td, int32_t* ts, uint8_t* flag) {
  block_sort(d, s, nullptr, n, seg, td, ts, nullptr);
  int any = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const bool dup = (i % seg) != 0 && s[i] == s[i - 1] && s[i] != kPad;
    flag[i] = dup;
    any |= dup;
  }
  if (!__syncthreads_or(any)) return;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (flag[i]) {
      d[i] = kInf;
      s[i] = kPad;
    }
  }
  block_sort(d, s, nullptr, n, seg, td, ts, nullptr);
}

__device__ __forceinline__ int level_of_id(long long id, int max_levels) {
  u64 z = static_cast<u64>(id) + 0x9E3779B97F4A7C15ull;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  z = z ^ (z >> 31);
  const u64 nz = ~z;  // trailing ones of z = trailing zeros of ~z
  const int tz = nz == 0 ? 64 : __ffsll(static_cast<long long>(nz)) - 1;
  return tz < max_levels - 1 ? tz : max_levels - 1;
}

// _greedy: walk to the locally nearest node at ``lvl`` from ``start``
template <typename T>
__device__ int32_t greedy(const Graph<T>& g, const Work& w, Scal* sc,
                          const long long* q, int lvl, int32_t start) {
  if (threadIdx.x < 32) {
    const bool ok = start >= 0 && g.valid[g.clip(start)] != 0;
    long long r = kInf;
    if (ok) r = dist_q(g.vrow(g.clip(start)), q, g.dim, threadIdx.x);
    if (threadIdx.x == 0) {
      sc->cur = start;
      sc->cur_d = r;
    }
  }
  __syncthreads();
  for (int64_t it = 0; it < g.cap; ++it) {
    const int32_t cur = sc->cur;
    // a Python index: -1 is the last row
    const int32_t* src = g.row(lvl, cur < 0 ? cur + g.cap : cur);
    for (int j = threadIdx.x; j < g.degree; j += blockDim.x) w.row[j] = src[j];
    __syncthreads();
    dists_to(g, q, w.row, nullptr, g.degree, kMasked, w.bd);
    if (threadIdx.x == 0) {
      int best = 0;  // argmin: ties to the lowest index
      for (int j = 1; j < g.degree; ++j)
        if (w.bd[j] < w.bd[best]) best = j;
      const long long bd = w.bd[best];
      const int32_t bs = w.row[best];
      const bool better = bd < sc->cur_d || (bd == sc->cur_d && bs < cur);
      if (better) {
        sc->cur = bs;
        sc->cur_d = bd;
      }
      sc->moved = better;
    }
    __syncthreads();
    if (!sc->moved) break;
  }
  const int32_t out = sc->cur;
  __syncthreads();
  return out;
}

// _search_layer: the ef-beam at ``lvl`` from ``entry``, left sorted in
// w.bd / w.bs[0, ef). ``fast`` is the construction path's bookkeeping
// (flags ride with the entries, no dedup); ``dead_ok`` ranks tombstones.
template <typename T>
__device__ void search_layer(const Graph<T>& g, const Work& w, Scal* sc,
                             const long long* q, int32_t entry, int lvl,
                             int ef, int max_iters, bool fast, bool dead_ok) {
  const int deg = g.degree;
  const int words = (g.cap + 31) >> 5;
  for (int i = threadIdx.x; i < words; i += blockDim.x) {
    w.seen[i] = 0;
    if (!fast) w.exp[i] = 0;
  }
  if (threadIdx.x < 32) {
    bool ok = entry >= 0;
    if (ok && !dead_ok) ok = g.valid[g.clip(entry)] != 0;
    long long r = kInf;
    if (ok) r = dist_q(g.vrow(g.clip(entry)), q, g.dim, threadIdx.x);
    if (threadIdx.x == 0) sc->d0 = r;
  }
  __syncthreads();
  if (threadIdx.x == 0 && entry >= 0 && entry < g.cap) set_bit(w.seen, entry, true);
  for (int i = threadIdx.x; i < ef; i += blockDim.x) {
    w.bd[i] = i ? kInf : sc->d0;
    w.bs[i] = i ? kPad : entry;
    w.bf[i] = 0;
  }
  __syncthreads();
  const Mode mode = dead_ok ? kTraverse : kMasked;
  for (int it = 0; it < max_iters; ++it) {
    if (threadIdx.x == 0) sc->pick = ef;
    __syncthreads();
    for (int i = threadIdx.x; i < ef; i += blockDim.x) {
      const bool un = w.bd[i] < kInf &&
                      (fast ? w.bf[i] == 0 : !bit(w.exp, g.clip(w.bs[i])));
      if (un) atomicMin(&sc->pick, i);
    }
    __syncthreads();
    const int pick = sc->pick;
    if (pick == ef) break;
    const int32_t cur = g.clip(w.bs[pick]);
    const int32_t* src = g.row(lvl, cur);
    for (int j = threadIdx.x; j < deg; j += blockDim.x) w.row[j] = src[j];
    __syncthreads();
    if (threadIdx.x == 0) {
      int any = 0;
      if (fast) {
        w.bf[pick] = 1;
        for (int j = 0; j < deg; ++j) {
          const int32_t x = w.row[j];
          const bool f = x >= 0 && !bit(w.seen, g.clip(x));
          w.fresh[j] = f;
          any |= f;
        }
        if (any)
          for (int j = 0; j < deg; ++j)
            if (w.row[j] >= 0) set_bit(w.seen, g.clip(w.row[j]), true);
      } else {
        set_bit(w.exp, cur, true);
        for (int j = 0; j < deg; ++j) {  // from the set before this step
          const int32_t x = w.row[j];
          const bool in = bit(w.seen, g.clip(x));
          w.fresh[j] = x >= 0 && !in;
          w.mark[j] = in || x >= 0;
          any |= w.fresh[j];
        }
        for (int j = 0; j < deg; ++j)  // in order: the last write wins
          set_bit(w.seen, g.clip(w.row[j]), w.mark[j] != 0);
      }
      sc->any = any;
    }
    __syncthreads();
    const bool any = sc->any != 0;
    if (fast && !any) continue;
    if (any) dists_to(g, q, w.row, w.fresh, deg, mode, w.bd + ef);
    for (int j = threadIdx.x; j < deg; j += blockDim.x) {
      const bool f = any && w.fresh[j];
      const int32_t x = w.row[j];
      if (!f) w.bd[ef + j] = kInf;
      w.bs[ef + j] = f ? (fast ? x : g.clip(x)) : kPad;
      w.bf[ef + j] = 0;
    }
    if (fast)
      block_sort(w.bd, w.bs, w.bf, ef + deg, ef + deg, w.td, w.ts, w.tf);
    else
      block_sort_dedup(w.bd, w.bs, ef + deg, ef + deg, w.td, w.ts, w.tf);
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    search_kernel(const Args args, Layout L) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ Scal sc;
  __shared__ int64_t a[A_COUNT];
  for (int i = threadIdx.x; i < A_COUNT; i += blockDim.x) a[i] = args.v[i];
  __syncthreads();
  const int b = blockIdx.x, s = blockIdx.y;
  const int64_t B = a[A_B];
  const int64_t cta = static_cast<int64_t>(s) * B + b;
  uint8_t* gmem = reinterpret_cast<uint8_t*>(a[A_SCRATCH]) + cta * L.gmem;
  const Work w = bind_work(L, smem, gmem);
  const Graph<T> g = graph_of<T>(a, s);
  const int ef = static_cast<int>(a[A_EF]);
  const int kk = static_cast<int>(a[A_KK]);
  const int64_t out_base = cta * kk;
  long long* out_ids = reinterpret_cast<long long*>(a[A_OUT_IDS]) + out_base;
  long long* out_d = reinterpret_cast<long long*>(a[A_OUT_D]) + out_base;
  int32_t* out_s = reinterpret_cast<int32_t*>(a[A_OUT_S]) + out_base;

  const int32_t entry = reinterpret_cast<const int32_t*>(a[A_ENTRY])[s];
  if (entry < 0) {  // no graph: every result is missing
    for (int i = threadIdx.x; i < kk; i += blockDim.x) {
      out_ids[i] = -1;
      out_d[i] = kInf;
      out_s[i] = -1;
    }
    return;
  }
  const long long* qsrc = reinterpret_cast<const long long*>(a[A_Q]) + b * a[A_DIM];
  for (int j = threadIdx.x; j < g.dim; j += blockDim.x) w.q[j] = qsrc[j];
  __syncthreads();
  const int32_t entry_safe = g.clip(entry);
  const int entry_level = g.levels[entry_safe];
  int32_t cur = entry_safe;
  for (int lvl = g.max_levels - 1; lvl > 0; --lvl)
    if (lvl <= entry_level) cur = greedy(g, w, &sc, w.q, lvl, cur);
  search_layer(g, w, &sc, w.q, cur, 0, ef, static_cast<int>(a[A_MAX_ITERS]),
               false, true);
  for (int i = threadIdx.x; i < ef; i += blockDim.x) {
    const bool live = w.bd[i] < kInf && g.valid[g.clip(w.bs[i])] != 0;
    if (!live) {
      w.bd[i] = kInf;
      w.bs[i] = kPad;
    }
  }
  block_sort(w.bd, w.bs, nullptr, ef, ef, w.td, w.ts, nullptr);
  for (int i = threadIdx.x; i < kk; i += blockDim.x) {
    const long long d = w.bd[i];
    const int32_t sl = w.bs[i];
    const bool ok = d < kInf;
    out_s[i] = ok ? sl : -1;
    out_ids[i] = ok ? g.ids[g.clip(sl)] : -1;
    out_d[i] = ok ? d : kInf;
  }
}

// _connect: new_slot's forward row to its m nearest candidates (w.cd /
// w.cs, sorted), each candidate's row pruned back to the degree with
// new_slot offered, by (distance to the owner, slot)
template <typename T>
__device__ void connect(const Graph<T>& g, const Work& w, Scal* sc, int lvl,
                        int32_t new_slot, int ef, int m, bool dedup) {
  const int deg = g.degree;
  int32_t* fwd = g.row(lvl, new_slot);
  for (int j = threadIdx.x; j < deg; j += blockDim.x) {
    const int src = j < ef - 1 ? j : ef - 1;
    fwd[j] = (j < m && w.cd[src] < kInf) ? w.cs[src] : -1;
  }
  const int mm = m < ef ? m : ef;
  if (threadIdx.x == 0) {
    int n = 0;
    for (int i = 0; i < mm; ++i)
      if (w.cd[i] < kInf && w.cs[i] != new_slot) w.own[n++] = w.cs[i];
    sc->n_own = n;
  }
  __syncthreads();
  const int n_own = sc->n_own;
  if (n_own == 0) return;
  for (int t = threadIdx.x; t < n_own * deg; t += blockDim.x)
    w.cur[t] = g.row(lvl, w.own[t / deg])[t % deg];
  __syncthreads();
  const int len = deg + 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int t = warp; t < n_own * len; t += kWarps) {
    const int o = t / len, j = t % len;
    const int32_t owner = w.own[o];
    long long r = kInf;
    int32_t sl;
    if (j < deg) {
      const int32_t x = w.cur[o * deg + j];
      if (x >= 0) r = dist_rows(g.vrow(g.clip(x)), g.vrow(owner), g.dim, lane);
      sl = x >= 0 ? x : kPad;
    } else {
      r = dist_rows(g.vrow(new_slot), g.vrow(owner), g.dim, lane);
      sl = new_slot;
    }
    if (lane == 0) {
      w.bd[t] = r;
      w.bs[t] = sl;
    }
  }
  __syncthreads();
  if (dedup)
    block_sort_dedup(w.bd, w.bs, n_own * len, len, w.td, w.ts, w.tf);
  else
    block_sort(w.bd, w.bs, nullptr, n_own * len, len, w.td, w.ts, nullptr);
  for (int t = threadIdx.x; t < n_own * deg; t += blockDim.x) {
    const int o = t / deg, j = t % deg;
    const int p = o * len + j;
    g.row(lvl, w.own[o])[j] = w.bd[p] < kInf ? w.bs[p] : -1;
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    insert_kernel(const Args args, Layout L) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ Scal sc;
  __shared__ int64_t a[A_COUNT];
  for (int i = threadIdx.x; i < A_COUNT; i += blockDim.x) a[i] = args.v[i];
  __syncthreads();
  const int s = blockIdx.x;
  uint8_t* gmem = reinterpret_cast<uint8_t*>(a[A_SCRATCH]) + s * L.gmem;
  const Work w = bind_work(L, smem, gmem);
  const Graph<T> g = graph_of<T>(a, s);
  const int ef = static_cast<int>(a[A_EF]);
  const int max_iters = static_cast<int>(a[A_MAX_ITERS]);
  const int m = static_cast<int>(a[A_M]);
  const bool fast = a[A_FAST] != 0;
  int32_t* entry_out = reinterpret_cast<int32_t*>(a[A_ENTRY]) + s;
  const int32_t* slots =
      reinterpret_cast<const int32_t*>(a[A_SLOTS]) + s * a[A_SLOTS_STRIDE];
  if (threadIdx.x == 0) sc.entry = *entry_out;
  __syncthreads();
  for (int64_t i = 0; i < a[A_N_REAL]; ++i) {
    const int32_t slot = slots[i];
    if (slot < 0 || slot >= g.cap) continue;  // a sentinel: skipped
    const T* src = g.vrow(slot);
    for (int j = threadIdx.x; j < g.dim; j += blockDim.x)
      w.q[j] = static_cast<long long>(src[j]);
    const int32_t entry = sc.entry;
    const bool is_first = entry < 0;
    const int raw_level = level_of_id(g.ids[slot], g.max_levels);
    const int32_t e = is_first ? slot : entry;
    const int entry_level = is_first ? raw_level : g.levels[g.clip(e)];
    const int node_level = raw_level < entry_level ? raw_level : entry_level;
    __syncthreads();  // every thread has read the entry and its level
    if (threadIdx.x == 0) {
      g.levels[slot] = node_level;
      sc.entry = e;
    }
    __syncthreads();
    if (is_first) continue;
    int32_t cur = e;
    for (int lvl = g.max_levels - 1; lvl > 0; --lvl)
      if (node_level < lvl && lvl <= entry_level)
        cur = greedy(g, w, &sc, w.q, lvl, cur);
    const int top = node_level < g.max_levels - 1 ? node_level : g.max_levels - 1;
    for (int lvl = top; lvl >= 0; --lvl) {
      search_layer(g, w, &sc, w.q, cur, lvl, ef, max_iters, fast, false);
      for (int j = threadIdx.x; j < ef; j += blockDim.x) {
        if (w.bs[j] == slot) {  // the new row itself leaves the candidates
          w.bd[j] = kInf;
          w.bs[j] = kPad;
        }
      }
      if (fast)
        block_sort(w.bd, w.bs, nullptr, ef, ef, w.td, w.ts, nullptr);
      else
        block_sort_dedup(w.bd, w.bs, ef, ef, w.td, w.ts, w.tf);
      for (int j = threadIdx.x; j < ef; j += blockDim.x) {
        w.cd[j] = w.bd[j];
        w.cs[j] = w.bs[j];
      }
      __syncthreads();
      connect(g, w, &sc, lvl, slot, ef, m, !fast);
      if (w.cd[0] < kInf) cur = w.cs[0];
      __syncthreads();
    }
  }
  if (threadIdx.x == 0) *entry_out = sc.entry;
}

template <typename T>
cudaError_t launch_typed(const int64_t* a, const Layout& L, cudaStream_t st) {
  Args args;
  for (int i = 0; i < A_COUNT; ++i) args.v[i] = a[i];
  const bool search = a[A_OP] == 0;
  const void* fn = search ? reinterpret_cast<const void*>(&search_kernel<T>)
                          : reinterpret_cast<const void*>(&insert_kernel<T>);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L.smem));
  if (err != cudaSuccess) return err;
  if (search) {
    const dim3 grid(static_cast<unsigned>(a[A_B]), static_cast<unsigned>(a[A_NS]));
    search_kernel<T><<<grid, kThreads, L.smem, st>>>(args, L);
  } else {
    insert_kernel<T><<<static_cast<unsigned>(a[A_NS]), kThreads, L.smem, st>>>(
        args, L);
  }
  return cudaGetLastError();
}

}  // namespace

// Bytes of global scratch a launch needs (every CTA's share of the
// workspace that does not fit its shared memory).
extern "C" int64_t qhnsw_scratch_bytes(const int64_t* a) {
  const Layout L = make_layout(a);
  const int64_t ctas = a[A_OP] == 0 ? a[A_B] * a[A_NS] : a[A_NS];
  return L.gmem * ctas;
}

// ``a`` is the argument array (enum Arg). Returns cudaGetLastError().
extern "C" int qhnsw_launch(const int64_t* a, void* stream) {
  if (a[A_NS] <= 0 || a[A_CAP] <= 0 || a[A_DIM] <= 0 || a[A_DEGREE] <= 0 ||
      a[A_LEVELS] <= 0 || a[A_EF] <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a[A_CAP] > 0x7fffffff || a[A_NS] > 65535 ||
      (a[A_OP] == 0 && (a[A_B] <= 0 || a[A_B] > 0x7fffffff)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout L = make_layout(a);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (a[A_ELEM]) {
    case 2: return static_cast<int>(launch_typed<int16_t>(a, L, st));
    case 4: return static_cast<int>(launch_typed<int32_t>(a, L, st));
    case 8: return static_cast<int>(launch_typed<long long>(a, L, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
