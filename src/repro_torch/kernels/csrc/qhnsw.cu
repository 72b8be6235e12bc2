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
// qhnsw_search: one cluster per (query, shard). Greedy descent from the
// entry at the upper levels, then the level-0 ef-beam that ranks tombstones
// by their stored rows (dead_ok), dead rows dropped from the answer, the
// (distance, slot) sort and the cut to min(k, ef).
// qhnsw_insert: one cluster per shard; it links the shard's list of stored
// slots into its graph in order (level from splitmix64 of the id capped by
// the entry's, the first node the entry, greedy descent, the
// ef_construction beam at each level, forward edges to the m nearest,
// each reverse row pruned to the degree by (distance to its owner, slot)),
// the fast or the default variant. The graph stays on the card.
//
// What bounds it: neither the bytes nor the operations. A beam is a chain
// of dependent steps, each reading up to degree rows (16 x 9216 bytes at
// d = 2304), and an insert run is a chain of beams: the time is the chain's
// latency. The design shortens each link of the chain:
//
//   * A thread-block cluster of C CTAs runs each beam. Each CTA owns a
//     fixed slice of the dimension (whole 16-byte units where the rows
//     allow it) and keeps its slice of the query or new row as int64. For
//     every candidate row it computes the wrapped uint64 partial sum of its
//     slice; the partials are summed in rank order through distributed
//     shared memory. Wrapped addition is associative and commutative, so
//     any split gives the same bits. Every CTA runs the same control on
//     the same sums and keeps its own identical beam, seen and expanded
//     bitmaps; rank 0 alone writes the graph, and a cluster barrier
//     (release / acquire) orders its writes before any rank reads them.
//     C comes from the shapes (make_plan): up to 8 for an insert, whose
//     run is one chain; 2 (1 for rows under 1 KB) for a search, whose
//     64-256 beams fill the card already.
//   * Rows are pulled whole: once an expansion's fresh neighbours are
//     known, each CTA brings its slice of every fresh row into shared
//     memory in one step (cp.async.bulk on an mbarrier; plain loads, all
//     issued before the barrier's arrival, where a row is no whole number
//     of 16-byte units), and the neighbour rows of the same nodes come in
//     the same step, into a pool that the beam's entries index: the next
//     expansion's row is in shared memory before the merge ends, and one
//     expansion costs about one memory round trip.
//   * Control off thread 0, with few barriers. Warp 0 picks the next node
//     and tests its row against the seen set by ballots (the default
//     scatter resolved per lane: the last lane that writes a slot wins),
//     writes the step's jobs and the bytes the rows' mbarrier expects; its
//     arrival on a jobs mbarrier starts the block: lane 0 of each warp
//     issues its share of the bulk copies (one warp issuing them all
//     would take them one by one), the threads issue the new candidates'
//     neighbour-row loads, wait on the rows' mbarrier and compute the
//     partials, one row per warp. After the cluster barrier every thread
//     sums its entry over the cluster and places it in the merge of the
//     sorted beam with the new entries (a count of the other list's
//     smaller keys; a rank sort only where the beam is not sorted); warp
//     0 places the dedup variant's blanks by prefix counts. Entries carry
//     a pool index, not their rows, and a 16-byte key, so a comparison is
//     one load. A step is two block barriers, one
//     cluster barrier and two mbarrier phases; the greedy argmin is a warp
//     shuffle on (distance, index), the owner list a ballot and prefix
//     count, and the valid mask a bitmap in shared memory.
//   * The reverse prune takes the new row's distance to each owner from
//     the beam (the wrapped sum of squared differences is symmetric) and
//     spreads the owners' remaining degree distances over the cluster,
//     their rows pulled as above.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

typedef unsigned long long u64;
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kInf = 1ll << 62;
constexpr int32_t kPad = 0x7fffffff;
constexpr int kThreads = 512;         // an insert's CTA
constexpr int kSearchThreads = 256;  // a search's
// dynamic shared memory a block may hold: 227 KB less the static scalars
constexpr int64_t kSmemMax = 232448 - 1024;
constexpr int kMaxCluster = 8;  // the portable cluster size

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

// workspace buffers, in the order they are offered shared memory; the
// exchange buffers and the jobs always take it, the row buffer (B_ROWS)
// takes what is left
enum Buf {
  B_X, B_JSLOT, B_JREF, B_JN, B_JRID,
  B_Q, B_BD, B_BS, B_TD, B_TS, B_TF, B_BK, B_BRID, B_TK, B_TRID,
  B_POOL, B_PRE,
  B_FLAG, B_CROW, B_VMAP, B_SEEN, B_EXP, B_CD, B_CS, B_OWN,
  B_OWND, B_CUR, B_OREF, B_ROWS, B_COUNT
};

struct Args {  // passed by value: a kernel's parameters hold 4 KB
  int64_t v[A_COUNT];
};

struct Plan {
  int64_t off[B_COUNT];
  int in_smem[B_COUNT];
  int64_t smem, gmem;  // bytes per CTA
  int cluster;         // C: CTAs per beam
  int threads;         // per CTA
  int bulk;            // 1: every row slice is whole 16-byte units
  int stride;          // bytes of a row slice in the row buffer
  int rows;            // row slices the buffer holds
  int slice;           // elements of the widest slice
  int nx;              // entries of one exchange buffer (jobs at once)
};

struct Work {
  u64* x;  // two exchange buffers of nx partial sums
  int32_t* jslot;  // a job's row (< 0: none), its reference (jref),
  int32_t* jref;   // the neighbour row to fetch with it (jn; < 0: none)
  int32_t* jn;     // and the pool slot that row goes to (jrid)
  int32_t* jrid;
  long long* q;
  long long* bd;  // (distance, slot) lists that block_sort sorts, with
  int32_t* bs;     // td / ts / tf its scratch; a beam ends in bd / bs
  long long* td;
  int32_t* ts;
  uint8_t* tf;
  longlong2* bk;   // the beam's two buffers: each entry's key (key_of)
  int32_t* brid;   // and its pool index
  longlong2* tk;
  int32_t* trid;
  int32_t* pool;  // neighbour rows of the beam's entries, by pool index
  int32_t* pre;
  uint8_t* flag;
  int32_t* crow;
  uint32_t* vmap;  // the valid mask, a bit per row
  uint32_t* seen;
  uint32_t* exp;
  long long* cd;
  int32_t* cs;
  int32_t* own;
  long long* ownd;
  int32_t* cur;
  long long* oref;
  uint8_t* rows;
  int nx;
};

// what warp 0 queued for the block (read after the mbarrier's phase)
enum Step { kRows, kStop, kMergeOnly };

struct Scal {  // block-wide scalars
  int step;    // a Step
  int32_t cur; // the greedy walk's last node
  int n_own;
};

// this CTA's part of its cluster's work
struct Ctx {
  int rank, size;    // rank in the cluster, CTAs in the cluster
  int lo, len;       // its slice of the dimension, in elements
  int bulk, stride, rows, slice;
  uint32_t jobs;     // mbarrier: warp 0 queued a step (shared address)
  uint32_t bar;      // mbarrier: the step's rows are in the row buffer
  uint32_t jphase;   // the parity of each barrier's next phase
  uint32_t phase;
  int xk;            // the exchange buffer the next step writes
};

// a beam: each entry's key and pool index. A key is (distance, slot and
// expanded packed so that their order is the pair's): one 16-byte load
// compares two entries
struct Beam {
  longlong2* key;
  int32_t* rid;
};

__device__ __forceinline__ longlong2 key_of(long long d, int32_t s, int f) {
  const long long sf =
      static_cast<long long>((static_cast<uint32_t>(s) ^ 0x80000000u)) << 8 |
      f;
  return make_longlong2(d, sf);
}
__device__ __forceinline__ int32_t slot_of(longlong2 k) {
  return static_cast<int32_t>(static_cast<uint32_t>(k.y >> 8) ^ 0x80000000u);
}
__device__ __forceinline__ bool flag_of(longlong2 k) { return k.y & 1; }
__device__ __forceinline__ bool kless(longlong2 a, longlong2 b) {
  return a.x < b.x || (a.x == b.x && a.y < b.y);
}
__device__ __forceinline__ bool keq(longlong2 a, longlong2 b) {
  return a.x == b.x && a.y == b.y;
}

int64_t align16(int64_t x) { return (x + 15) & ~int64_t(15); }

Plan plan_for(const int64_t* a, int64_t c) {
  Plan p = {};
  const int64_t op = a[A_OP], cap = a[A_CAP], dim = a[A_DIM];
  const int64_t deg = a[A_DEGREE], ef = a[A_EF], elem = a[A_ELEM];
  const int64_t m = op == 1 ? a[A_M] : 0;
  const int64_t mm = m < ef ? m : ef;
  const bool need_exp = op == 0 || a[A_FAST] == 0;
  p.bulk = (dim * elem) % 16 == 0 && a[A_VEC] % 16 == 0 &&
           (a[A_VEC_SS] * elem) % 16 == 0;
  int64_t slice, stride;
  if (p.bulk) {
    const int64_t units = dim * elem / 16;
    if (c > units) c = units;
    stride = (units + c - 1) / c * 16;
    slice = stride / elem;
  } else {
    if (c > dim) c = dim;
    slice = (dim + c - 1) / c;
    stride = align16(slice * elem);
  }
  p.cluster = static_cast<int>(c);
  p.threads = op == 1 ? kThreads : kSearchThreads;
  p.stride = static_cast<int>(stride);
  p.slice = static_cast<int>(slice);
  const int64_t n = ef + deg;  // a beam and its new entries
  int64_t nmax = n;
  if (mm * (deg + 1) > nmax) nmax = mm * (deg + 1);
  const int64_t nx = deg > mm * deg ? deg : mm * deg;
  p.nx = static_cast<int>(nx);
  const int64_t words = (cap + 31) / 32;
  int64_t size[B_COUNT] = {
      2 * nx * 8, nx * 4, nx * 4, nx * 4, nx * 4,
      slice * 8, nmax * 8, nmax * 4, nmax * 8, nmax * 4, nmax,
      n * 16, n * 4, n * 16, n * 4, n * deg * 4, n * 4,
      n, deg * 4, words * 4, words * 4, need_exp ? words * 4 : 0,
      op == 1 ? ef * 8 : 0, op == 1 ? ef * 4 : 0,
      mm * 4, mm * 8, mm * deg * 4, mm * slice * 8, 0};
  // the row buffer keeps room for one beam step's rows (degree of them)
  const int64_t want_rows = nx < 1 ? 1 : nx;
  const int64_t min_rows = deg < want_rows ? deg : want_rows;
  int64_t reserve = min_rows * stride;
  if (reserve > kSmemMax / 2) reserve = stride;
  p.smem = 0;
  p.gmem = 0;
  for (int b = 0; b < B_ROWS; ++b) {
    const int64_t s = align16(size[b]);
    const bool forced = b <= B_JRID;
    if (forced || p.smem + s + reserve <= kSmemMax) {
      p.in_smem[b] = 1;
      p.off[b] = p.smem;
      p.smem += s;
    } else {
      p.in_smem[b] = 0;
      p.off[b] = p.gmem;
      p.gmem += s;
    }
  }
  int64_t rows = (kSmemMax - p.smem) / stride;
  if (rows > want_rows) rows = want_rows;
  p.rows = rows < 0 ? 0 : static_cast<int>(rows);
  p.in_smem[B_ROWS] = 1;
  p.off[B_ROWS] = p.smem;
  p.smem += p.rows * stride;
  return p;
}

// C from the shapes. An insert run is one chain: up to 8 CTAs share it
// while a slice keeps at least 128 bytes. A search has a beam per (query,
// shard) and 64-256 of them fill the card: 2 CTAs per beam where a slice
// keeps 512 bytes, else 1 (at d = 2304, 64 and 256 beams, 2 measured
// faster than 1 and 4 on an H100).
Plan make_plan(const int64_t* a) {
  const int64_t bytes = a[A_DIM] * a[A_ELEM];
  int c = 1;
  if (a[A_OP] == 1) {
    c = kMaxCluster;
    while (c > 1 && bytes / c < 128) c >>= 1;
  } else if (bytes >= 1024) {
    c = 2;
  }
  return plan_for(a, c);
}

__device__ Work bind_work(const Plan& P, uint8_t* smem, uint8_t* gmem) {
  void* p[B_COUNT];
#pragma unroll
  for (int b = 0; b < B_COUNT; ++b)
    p[b] = (P.in_smem[b] ? smem : gmem) + P.off[b];
  Work w;
  w.x = static_cast<u64*>(p[B_X]);
  w.jslot = static_cast<int32_t*>(p[B_JSLOT]);
  w.jref = static_cast<int32_t*>(p[B_JREF]);
  w.jn = static_cast<int32_t*>(p[B_JN]);
  w.jrid = static_cast<int32_t*>(p[B_JRID]);
  w.q = static_cast<long long*>(p[B_Q]);
  w.bd = static_cast<long long*>(p[B_BD]);
  w.bs = static_cast<int32_t*>(p[B_BS]);
  w.td = static_cast<long long*>(p[B_TD]);
  w.ts = static_cast<int32_t*>(p[B_TS]);
  w.tf = static_cast<uint8_t*>(p[B_TF]);
  w.bk = static_cast<longlong2*>(p[B_BK]);
  w.brid = static_cast<int32_t*>(p[B_BRID]);
  w.tk = static_cast<longlong2*>(p[B_TK]);
  w.trid = static_cast<int32_t*>(p[B_TRID]);
  w.pool = static_cast<int32_t*>(p[B_POOL]);
  w.pre = static_cast<int32_t*>(p[B_PRE]);
  w.flag = static_cast<uint8_t*>(p[B_FLAG]);
  w.crow = static_cast<int32_t*>(p[B_CROW]);
  w.vmap = static_cast<uint32_t*>(p[B_VMAP]);
  w.seen = static_cast<uint32_t*>(p[B_SEEN]);
  w.exp = static_cast<uint32_t*>(p[B_EXP]);
  w.cd = static_cast<long long*>(p[B_CD]);
  w.cs = static_cast<int32_t*>(p[B_CS]);
  w.own = static_cast<int32_t*>(p[B_OWN]);
  w.ownd = static_cast<long long*>(p[B_OWND]);
  w.cur = static_cast<int32_t*>(p[B_CUR]);
  w.oref = static_cast<long long*>(p[B_OREF]);
  w.rows = static_cast<uint8_t*>(p[B_ROWS]);
  w.nx = P.nx;
  return w;
}

// the beam's two buffers: side 0 is w.bk / w.brid, side 1 w.tk / w.trid
__device__ __forceinline__ Beam beam_of(const Work& w, int side) {
  return side ? Beam{w.tk, w.trid} : Beam{w.bk, w.brid};
}

// ---------------------------------------------------------------------------
// Hopper's asynchronous copy and its barrier
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// this thread's arrival, expecting ``bytes`` of asynchronous copies
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// shared memory that threads have read, before the async proxy writes it
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cluster_sync(const Ctx& c) {
  if (c.size > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

__device__ Ctx make_ctx(const Plan& P, int dim, int elem, uint64_t* bar) {
  // bar[0]: the jobs, bar[1]: the rows
  Ctx c;
  c.size = P.cluster;
  c.rank = static_cast<int>(cg::this_cluster().block_rank());
  if (P.bulk) {
    const int units = dim * elem / 16;
    const int u0 = c.rank * units / c.size, u1 = (c.rank + 1) * units / c.size;
    c.lo = u0 * 16 / elem;
    c.len = (u1 - u0) * 16 / elem;
  } else {
    c.lo = c.rank * dim / c.size;
    c.len = (c.rank + 1) * dim / c.size - c.lo;
  }
  c.bulk = P.bulk;
  c.stride = P.stride;
  c.rows = P.rows;
  c.slice = P.slice;
  c.jobs = smem_addr(bar);
  c.bar = smem_addr(bar + 1);
  c.jphase = 0;
  c.phase = 0;
  c.xk = 0;
  if (threadIdx.x == 0) {
    mbar_init(c.jobs, 1);
    mbar_init(c.bar, 1);
  }
  __syncthreads();
  return c;
}

// ---------------------------------------------------------------------------
// one shard's graph
// ---------------------------------------------------------------------------

__device__ __forceinline__ bool bit(const uint32_t* m, int32_t x) {
  return (m[x >> 5] >> (x & 31)) & 1u;
}

template <typename T>
struct Graph {
  const T* vec;
  const long long* ids;
  const uint8_t* valid;
  const uint32_t* vmap;  // valid as bits, in the CTA's workspace
  int32_t* nbr;  // written by rank 0 only; read past L1 (__ldcg)
  int32_t* levels;
  int64_t lvl_stride;
  int32_t cap;
  int dim, degree, max_levels;

  __device__ int32_t clip(int64_t x) const {
    return x < 0 ? 0 : (x >= cap ? cap - 1 : static_cast<int32_t>(x));
  }
  // a Python index: -1 is the last row
  __device__ int32_t pyrow(int32_t x) const { return clip(x < 0 ? x + cap : x); }
  __device__ int32_t* row(int lvl, int32_t slot) const {
    return nbr + lvl * lvl_stride + static_cast<int64_t>(slot) * degree;
  }
  __device__ const T* vrow(int32_t slot) const {
    return vec + static_cast<int64_t>(slot) * dim;
  }
  __device__ bool live(int32_t x) const { return bit(vmap, clip(x)); }
  __device__ bool ok(int32_t x) const { return x >= 0 && live(x); }  // _wide_l2
};

template <typename T>
__device__ Graph<T> graph_of(const int64_t* a, int s) {
  Graph<T> g;
  g.vec = reinterpret_cast<const T*>(a[A_VEC]) + s * a[A_VEC_SS];
  g.ids = reinterpret_cast<const long long*>(a[A_IDS]) + s * a[A_ROW_SS];
  g.valid = reinterpret_cast<const uint8_t*>(a[A_VALID]) + s * a[A_ROW_SS];
  g.vmap = nullptr;
  g.levels = reinterpret_cast<int32_t*>(a[A_LVL]) + s * a[A_ROW_SS];
  g.nbr = reinterpret_cast<int32_t*>(a[A_NBR]) + s * a[A_NBR_SS];
  g.lvl_stride = a[A_NBR_LS];
  g.cap = static_cast<int32_t>(a[A_CAP]);
  g.dim = static_cast<int>(a[A_DIM]);
  g.degree = static_cast<int>(a[A_DEGREE]);
  g.max_levels = static_cast<int>(a[A_LEVELS]);
  return g;
}

// the valid mask as bits (the kernels write no row's valid). Ends synced.
template <typename T>
__device__ void load_valid(Graph<T>& g, uint32_t* vmap) {
  const int words = (g.cap + 31) >> 5;
  const bool vec16 = (reinterpret_cast<uintptr_t>(g.valid) & 15) == 0;
  for (int i = threadIdx.x; i < words; i += blockDim.x) {
    uint32_t m = 0;
    if (vec16 && 32 * (i + 1) <= g.cap) {
      const uint4* v = reinterpret_cast<const uint4*>(g.valid + 32 * i);
      const uint4 lo = __ldg(v), hi = __ldg(v + 1);
      const uint32_t part[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int b = 0; b < 32; ++b)
        if ((part[b >> 2] >> (8 * (b & 3))) & 0xffu) m |= 1u << b;
    } else {
      for (int b = 0; b < 32 && 32 * i + b < g.cap; ++b)
        if (__ldg(g.valid + 32 * i + b)) m |= 1u << b;
    }
    vmap[i] = m;
  }
  g.vmap = vmap;
  __syncthreads();
}

// ---------------------------------------------------------------------------
// distances: rows pulled into shared memory, partials summed over the
// cluster
// ---------------------------------------------------------------------------

// Warp 0: queue the row slices of jobs [r0, r0 + nr) (w.jslot; a job < 0
// has none) into the row buffer. With bulk copies, its arrival on the
// rows barrier expects their bytes, then its arrival on the jobs barrier
// (the jobs are written) lets lane 0 of every warp issue its rows' copies
// (issue_rows): one warp issuing them all would take them one by one.
// Otherwise it loads the rows itself, every load issued before its
// arrival on the rows barrier, and then arrives on the jobs barrier.
// Every thread then waits for both (sum_rows). ``cnt``: the group's jobs
// with a row where the caller has counted them, else -1.
template <typename T>
__device__ __forceinline__ void queue_rows(const Graph<T>& g, const Work& w,
                                          const Ctx& c, int r0, int nr,
                                          int cnt = -1) {
  const int lane = threadIdx.x & 31;
  const uint32_t bytes = static_cast<uint32_t>(c.len * sizeof(T));
  if (c.bulk) {
    if (cnt < 0) {
      cnt = 0;
      for (int i0 = 0; i0 < nr; i0 += 32)
        cnt += __popc(__ballot_sync(
            kFull, i0 + lane < nr && w.jslot[r0 + i0 + lane] >= 0));
    }
    if (lane == 0) {
      mbar_expect(c.bar, cnt * bytes);
      mbar_expect(c.jobs, 0);
    }
  } else {
    for (int t = lane; t < nr * c.len; t += 32) {
      const int i = t / c.len, j = t - i * c.len;
      const int32_t s = w.jslot[r0 + i];
      if (s >= 0)
        reinterpret_cast<T*>(w.rows + i * c.stride)[j] =
            __ldg(g.vrow(s) + c.lo + j);
    }
    __threadfence_block();
    __syncwarp();
    if (lane == 0) {
      mbar_expect(c.bar, 0);
      mbar_expect(c.jobs, 0);
    }
  }
}

// Lane 0 of each warp: the bulk copies of its share of jobs [r0, r0 + nr),
// once the jobs barrier's phase has come (the rows barrier expects them)
template <typename T>
__device__ __forceinline__ void issue_rows(const Graph<T>& g, const Work& w,
                                          const Ctx& c, int r0, int nr) {
  const uint32_t bytes = static_cast<uint32_t>(c.len * sizeof(T));
  if (!c.bulk || !bytes || (threadIdx.x & 31)) return;
  fence_proxy_async();  // the buffer's last reads are ordered before
  for (int i = threadIdx.x >> 5; i < nr; i += blockDim.x >> 5) {
    const int32_t s = w.jslot[r0 + i];
    if (s >= 0)
      bulk_load(smem_addr(w.rows + i * c.stride), g.vrow(s) + c.lo, bytes,
                c.bar);
  }
}

// Every thread: the partial sums, over the CTA's slice, of n jobs whose
// first group warp 0 has queued; job i holds row w.jslot[i] against the
// int64 reference ref + w.jref[i] * ref_stride (ref itself unless
// per_job), one warp per row, into exchange buffer c.xk; the next groups
// are queued here. With lvl >= 0 the threads also copy each job's
// neighbour row at lvl (w.jn) to its pool slot (w.jrid), their loads in
// flight while the partials are computed. Then the cluster barrier.
// Returns that buffer (c.xk moves to the other one); where ``steered``,
// -1 if warp 0 ended the beam (sc->step kStop) and -2 if its step pulls
// no row (kMergeOnly: no partials, no cluster barrier).
template <typename T>
__device__ __forceinline__ int sum_rows(const Graph<T>& g, const Work& w,
                                        Ctx& c, const Scal* sc, bool steered,
                                        int n, const long long* ref,
                                        bool per_job, int ref_stride,
                                        int lvl) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5, deg = g.degree;
  u64* x = w.x + c.xk * w.nx;
  for (int r0 = 0; r0 == 0 || r0 < n; r0 += c.rows) {
    const int nr = n - r0 < c.rows ? n - r0 : c.rows;
    if (r0 > 0) {
      __syncthreads();  // the buffer's last group is read
      if (warp == 0) queue_rows(g, w, c, r0, nr);
    }
    mbar_wait(c.jobs, c.jphase);
    c.jphase ^= 1u;
    if (steered && r0 == 0 && sc->step != kRows)
      return sc->step == kStop ? -1 : -2;
    issue_rows(g, w, c, r0, nr);
    int32_t nv = 0, nt = -1;  // this thread's first neighbour-row entry
    if (r0 == 0 && lvl >= 0) {
      for (int t = threadIdx.x; t < n * deg; t += blockDim.x) {
        const int i = t / deg;
        const int32_t r = w.jn[i];
        if (r < 0) continue;
        const int32_t v = __ldcg(g.row(lvl, r) + (t - i * deg));
        const int dst = w.jrid[i] * deg + (t - i * deg);
        if (nt < 0) {
          nv = v;
          nt = dst;
        } else {
          w.pool[dst] = v;
        }
      }
    }
    mbar_wait(c.bar, c.phase);  // the loads above are in flight meanwhile
    c.phase ^= 1u;
    for (int i = warp; i < nr; i += warps) {
      const int32_t s = w.jslot[r0 + i];
      u64 acc = 0;
      if (s >= 0) {
        const T* row = reinterpret_cast<const T*>(w.rows + i * c.stride);
        const long long* q = ref + (per_job ? w.jref[r0 + i] * ref_stride : 0);
#pragma unroll 4
        for (int j = lane; j < c.len; j += 32) {
          const u64 d = static_cast<u64>(static_cast<long long>(row[j])) -
                        static_cast<u64>(q[j]);
          acc += d * d;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          acc += __shfl_xor_sync(kFull, acc, off);
      }
      if (lane == 0) x[r0 + i] = acc;
    }
    if (nt >= 0) w.pool[nt] = nv;
  }
  // every rank's partials are written. A rank writes this buffer again
  // two steps on, past the next barrier, which every rank reaches done
  // reading it
  cluster_sync(c);
  const int k = c.xk;
  c.xk ^= 1;
  return k;
}

// the cluster's sum of job i's partials in exchange buffer k, rank by
// rank through distributed shared memory (every load issued before the
// first add)
__device__ __forceinline__ long long total(const Work& w, const Ctx& c,
                                           int k, int i) {
  u64* x = w.x + k * w.nx + i;
  if (c.size == 1) return static_cast<long long>(*x);
  cg::cluster_group cl = cg::this_cluster();
  u64 v[kMaxCluster];
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r)
    v[r] = r < c.size ? *cl.map_shared_rank(x, r) : 0ull;
  u64 s = 0;
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r) s += v[r];
  return static_cast<long long>(s);
}

// Every thread: the distances of n jobs the threads have written (job i by
// thread i, or before a barrier) into out[i]. Ends synced.
template <typename T>
__device__ void dists(const Graph<T>& g, const Work& w, Ctx& c, int n,
                      const long long* ref, bool per_job, int ref_stride,
                      long long* out) {
  __syncthreads();
  if (threadIdx.x < 32) queue_rows(g, w, c, 0, n < c.rows ? n : c.rows);
  const int k =
      sum_rows(g, w, c, nullptr, false, n, ref, per_job, ref_stride, -1);
  for (int i = threadIdx.x; i < n; i += blockDim.x) out[i] = total(w, c, k, i);
  __syncthreads();
}

// ---------------------------------------------------------------------------
// sorts and the beam's merge
// ---------------------------------------------------------------------------

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

// Every thread: the step's sums (exchange buffer k, where k >= 0) into the
// new entries A[ef, n) of the beam A[0, ef) (A the buffer ``side``), then
// sorted(beam + new) by (distance, slot, expanded) into the other buffer,
// each entry with its pool index: all n entries are placed (a
// permutation), so the ones past ef give their pool slots to the next
// step's new entries. A sorted beam is merged (an entry's place is its
// index plus a count of the other list's smaller keys, one thread per
// entry); a beam a flag or a wrapped distance left unsorted is rank sorted.
// Equal keys are equal entries, so the order of ties changes no value.
// With ``dedup``, warp 0 then applies _sort_dedup_entries's blanks (the
// rest of the block goes on). Returns the buffer that holds the beam.
__device__ __forceinline__ int place(const Work& w, const Ctx& c, int k,
                                     int side, int ef, int n, bool dedup) {
  const int tid = threadIdx.x, lane = tid & 31, deg = n - ef;
  const Beam A = beam_of(w, side), B = beam_of(w, side ^ 1);
  if (k >= 0)
    for (int j = tid; j < deg; j += blockDim.x)
      if (w.jslot[j] >= 0) A.key[ef + j].x = total(w, c, k, j);
  int ok = 1;
  for (int i = tid + 1; i < ef; i += blockDim.x)
    if (kless(A.key[i], A.key[i - 1])) ok = 0;
  const bool sorted = __syncthreads_and(ok);  // and the sums are in
  for (int e = tid; e < n; e += blockDim.x) {
    const longlong2 ke = A.key[e];
    int pos = 0;
    if (!sorted) {
      for (int q = 0; q < n; ++q) {
        const longlong2 kq = A.key[q];
        pos += kless(kq, ke) || (keq(kq, ke) && q < e);
      }
    } else if (e < ef) {
      pos = e;
#pragma unroll 4
      for (int q = ef; q < n; ++q) pos += kless(A.key[q], ke);
    } else {
      int lo = 0, hi = ef;  // beam entries <= this one
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (kless(ke, A.key[mid]))
          hi = mid;
        else
          lo = mid + 1;
      }
      pos = lo;
#pragma unroll 4
      for (int q = ef; q < n; ++q) {
        const longlong2 kq = A.key[q];
        pos += kless(kq, ke) || (keq(kq, ke) && q < e);
      }
    }
    B.key[pos] = ke;
    B.rid[pos] = A.rid[e];
  }
  __syncthreads();
  if (!dedup) return side ^ 1;
  if (tid >= 32) return side;
  // warp 0, B into A: keep an entry unless it repeats the slot before it
  // (no flag is set on this path: a key's second half is its slot). The
  // kept entries keep their order; the blanks (INF, PAD) go where that
  // key sorts: after every kept key but those past it (distances above
  // INF, wrapped)
  const longlong2 blank = key_of(kInf, kPad, 0);
  uint8_t* flag = w.flag;
  int32_t* pre = w.pre;
  int kept = 0, big = n;
  for (int i0 = 0; i0 < n; i0 += 32) {
    const int p = i0 + lane;
    bool keep = false, past = false;
    if (p < n) {
      const long long y = B.key[p].y;
      keep = !(p > 0 && y == B.key[p - 1].y && y != blank.y);
      past = B.key[p].x > kInf;
    }
    const unsigned kb = __ballot_sync(kFull, keep);
    const unsigned pb = __ballot_sync(kFull, past);
    if (p < n) {
      flag[p] = keep;
      pre[p] = kept + __popc(kb & ((1u << lane) - 1u));
    }
    kept += __popc(kb);
    if (big == n && pb) big = i0 + __ffs(pb) - 1;
  }
  __syncwarp();
  const int blanks = n - kept;
  const int le = big < n ? pre[big] : kept;
  for (int p = lane; p < n; p += 32) {
    const bool keep = flag[p];
    const int f = keep ? pre[p] + (p >= big ? blanks : 0) : le + (p - pre[p]);
    A.key[f] = keep ? B.key[p] : blank;
    A.rid[f] = B.rid[p];
  }
  __syncwarp();
  return side;
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

// ---------------------------------------------------------------------------
// greedy descent and the beam
// ---------------------------------------------------------------------------

// warp 0: a greedy step's jobs (the current node's neighbours, w.crow),
// queued; their neighbour rows (any of them may be the next node) go to
// the pool, row j at pool + j deg
template <typename T>
__device__ __forceinline__ void greedy_queue(const Graph<T>& g,
                                            const Work& w, const Ctx& c) {
  const int lane = threadIdx.x & 31, deg = g.degree;
  const int nr = deg < c.rows ? deg : c.rows;
  int cnt = 0;  // the first group's jobs with a row
  for (int j0 = 0; j0 < deg; j0 += 32) {
    const int j = j0 + lane;
    bool ok = false;
    if (j < deg) {
      const int32_t x = w.crow[j];
      ok = g.ok(x);
      w.jslot[j] = ok ? g.clip(x) : -1;
      w.jn[j] = g.pyrow(x);
      w.jrid[j] = j;
    }
    cnt += __popc(__ballot_sync(kFull, ok && j < nr));
  }
  __syncwarp();
  queue_rows(g, w, c, 0, nr, cnt);
}

// _greedy: walk to the locally nearest node at ``lvl`` from ``start``.
// Warp 0 steers; each step pulls the current node's neighbours with their
// neighbour rows, and the argmin is a warp shuffle on (distance, index),
// ties to the lowest index.
template <typename T>
__device__ int32_t greedy(const Graph<T>& g, const Work& w, Ctx& c,
                          Scal* sc, int lvl, int32_t start) {
  const int deg = g.degree, tid = threadIdx.x, lane = tid & 31;
  const bool ok0 = g.ok(start);
  if (tid == 0) {
    w.jslot[0] = ok0 ? g.clip(start) : -1;
    sc->step = kRows;
  }
  for (int j = tid; j < deg; j += blockDim.x)
    w.crow[j] = __ldcg(g.row(lvl, g.pyrow(start)) + j);
  dists(g, w, c, 1, w.q, false, 0, w.td);
  int32_t cur = start;
  long long cur_d = ok0 ? w.td[0] : kInf;
  int64_t it = 0;
  if (tid < 32) greedy_queue(g, w, c);
  for (;;) {
    const int k = sum_rows(g, w, c, sc, true, deg, w.q, false, 0, lvl);
    if (k < 0) break;
    if (tid >= 32) continue;
    long long bd = 0;
    int best = -1;
    for (int j0 = 0; j0 < deg; j0 += 32) {
      const int j = j0 + lane;
      long long d = 0;
      int idx = -1;
      if (j < deg) {
        d = w.jslot[j] >= 0 ? total(w, c, k, j) : kInf;
        idx = j;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const long long od = __shfl_xor_sync(kFull, d, off);
        const int oi = __shfl_xor_sync(kFull, idx, off);
        if (oi >= 0 && (idx < 0 || od < d || (od == d && oi < idx))) {
          d = od;
          idx = oi;
        }
      }
      if (best < 0 || d < bd) {  // a later chunk wins only if smaller
        bd = d;
        best = idx;
      }
    }
    const int32_t bs = w.crow[best];
    const bool better = bd < cur_d || (bd == cur_d && bs < cur);
    ++it;
    if (better) {
      cur = bs;
      cur_d = bd;
      __syncwarp();
      for (int j = lane; j < deg; j += 32) w.crow[j] = w.pool[best * deg + j];
      __syncwarp();
    }
    if (better && it < g.cap) {
      greedy_queue(g, w, c);
    } else {
      if (lane == 0) {
        sc->cur = cur;
        sc->step = kStop;
        mbar_expect(c.jobs, 0);
      }
      __syncwarp();
    }
  }
  __syncthreads();  // every thread has read sc->step and the walk's end
  return sc->cur;
}

// the first beam entry not yet expanded (ef if none): one warp's ballots
template <typename T>
__device__ __forceinline__ int first_open(const Graph<T>& g, const Work& w,
                                          int side, int ef, bool fast) {
  const int lane = threadIdx.x & 31;
  const Beam A = beam_of(w, side);
  for (int i0 = 0; i0 < ef; i0 += 32) {
    const int i = i0 + lane;
    bool un = false;
    const longlong2 k = i < ef ? A.key[i] : key_of(kInf, kPad, 0);
    if (k.x < kInf)
      un = fast ? !flag_of(k) : !bit(w.exp, g.clip(slot_of(k)));
    const unsigned b = __ballot_sync(kFull, un);
    if (b) return i0 + __ffs(b) - 1;
  }
  return ef;
}

// Warp 0: expand entry ``pick`` of A: mark it, test its neighbour row
// against the seen set, set the new entries A[ef, ef + deg) (distance INF
// until summed) and the jobs of the fresh rows' distances (each with its
// neighbour row for the pool slot its entry holds), all from the set
// before this step; then update the set (the fast path: every x >= 0
// once anything is fresh; the default: the reference's scatter, the last
// lane writing a slot wins). Returns whether any neighbour was fresh;
// ``want`` / ``first`` count the jobs with a row, in all and among the
// first ``rows``.
template <typename T>
__device__ __forceinline__ bool expand(const Graph<T>& g, const Work& w,
                                       int side, int pick, int ef, bool fast,
                                       bool dead_ok, int rows, int& want,
                                       int& first) {
  const int lane = threadIdx.x & 31, deg = g.degree;
  const Beam A = beam_of(w, side);
  const int32_t* row = w.pool + A.rid[pick] * deg;
  if (lane == 0) {
    if (fast) {
      A.key[pick].y |= 1;
    } else {
      const int32_t cur = g.clip(slot_of(A.key[pick]));
      w.exp[cur >> 5] |= 1u << (cur & 31);
    }
  }
  unsigned any = 0;
  want = first = 0;
  for (int j0 = 0; j0 < deg; j0 += 32) {
    const int j = j0 + lane;
    bool f = false, ok = false;
    if (j < deg) {
      const int32_t x = row[j], sf = g.clip(x);
      const bool in = bit(w.seen, sf);
      f = x >= 0 && !in;
      if (!fast) w.flag[j] = in || x >= 0;  // the mark this lane scatters
      ok = f && (dead_ok || g.live(x));
      w.jslot[j] = ok ? sf : -1;
      w.jn[j] = ok ? sf : -1;
      w.jrid[j] = A.rid[ef + j];
      A.key[ef + j] = key_of(kInf, f ? (fast ? x : sf) : kPad, 0);
    }
    any |= __ballot_sync(kFull, f);
    want += __popc(__ballot_sync(kFull, ok));
    first += __popc(__ballot_sync(kFull, ok && j < rows));
  }
  __syncwarp();
  if (fast) {
    if (any) {
      for (int j = lane; j < deg; j += 32) {
        const int32_t x = row[j];
        if (x >= 0) {
          const int32_t sf = g.clip(x);
          atomicOr(&w.seen[sf >> 5], 1u << (sf & 31));
        }
      }
    }
  } else {
    for (int j0 = 0; j0 < deg; j0 += 32) {  // chunks in order
      const int j = j0 + lane;
      const int32_t sf = j < deg ? g.clip(row[j]) : -1 - lane;
      const unsigned same = __match_any_sync(kFull, sf);
      if (j < deg && 31 - __clz(same) == lane) {  // the last write wins
        const uint32_t m = 1u << (sf & 31);
        if (w.flag[j])
          atomicOr(&w.seen[sf >> 5], m);
        else
          atomicAnd(&w.seen[sf >> 5], ~m);
      }
      __syncwarp();
    }
  }
  __syncwarp();
  return any != 0;
}

// Warp 0, between a beam's steps (the beam in buffer ``side``): expand
// until a step needs the block: rows to pull (queue them: the other
// threads bring the new entries' neighbour rows into the pool), a merge
// with no row to pull (kMergeOnly), or the beam's end (kStop); then the
// arrival on the mbarrier.
template <typename T>
__device__ __forceinline__ void steer(const Graph<T>& g, const Work& w,
                                      const Ctx& c, Scal* sc, int side,
                                      int ef, int max_iters, bool fast,
                                      bool dead_ok, int& it) {
  const int lane = threadIdx.x & 31, deg = g.degree;
  int step = kStop, cnt = 0;
  while (it < max_iters) {
    const int pick = first_open(g, w, side, ef, fast);
    if (pick == ef) break;
    ++it;
    int want, first;  // jobs with a row: in all, in group 0
    const bool any =
        expand(g, w, side, pick, ef, fast, dead_ok, c.rows, want, first);
    if (fast && !any) continue;
    step = want ? kRows : kMergeOnly;
    cnt = first;
    break;
  }
  if (lane == 0) sc->step = step;
  __syncwarp();
  if (step == kRows)
    queue_rows(g, w, c, 0, deg < c.rows ? deg : c.rows, cnt);
  else if (lane == 0)
    mbar_expect(c.jobs, 0);
  __syncwarp();
}

// _search_layer: the ef-beam at ``lvl`` from ``entry``, left sorted in
// w.bd / w.bs[0, ef). ``fast`` is the construction path's bookkeeping
// (flags ride with the entries, no dedup); ``dead_ok`` ranks tombstones.
template <typename T>
__device__ void search_layer(const Graph<T>& g, const Work& w, Ctx& c,
                             Scal* sc, int32_t entry, int lvl, int ef,
                             int max_iters, bool fast, bool dead_ok) {
  const int deg = g.degree, tid = threadIdx.x, lane = tid & 31;
  const int words = (g.cap + 31) >> 5, n = ef + deg;
  for (int i = tid; i < words; i += blockDim.x) {
    w.seen[i] = 0;
    if (!fast) w.exp[i] = 0;
  }
  const bool ok = dead_ok ? entry >= 0 : g.ok(entry);
  if (tid == 0) w.jslot[0] = ok ? g.clip(entry) : -1;
  for (int j = tid; j < deg; j += blockDim.x)  // pool index 0: the entry's
    w.pool[j] = __ldcg(g.row(lvl, g.clip(entry)) + j);
  dists(g, w, c, 1, w.q, false, 0, w.td);
  const long long d0 = ok ? w.td[0] : kInf;
  if (tid == 0 && entry >= 0 && entry < g.cap)
    w.seen[entry >> 5] |= 1u << (entry & 31);
  for (int i = tid; i < n; i += blockDim.x) {
    w.bk[i] = i ? key_of(kInf, kPad, 0) : key_of(d0, entry, 0);
    w.brid[i] = i;
  }
  __syncthreads();
  int side = 0, it = 0;  // every thread keeps the side; warp 0 the count
  if (tid < 32) steer(g, w, c, sc, side, ef, max_iters, fast, dead_ok, it);
  for (;;) {
    const int k = sum_rows(g, w, c, sc, true, deg, w.q, false, 0, lvl);
    if (k == -1) break;
    side = place(w, c, k, side, ef, n, !fast);
    if (tid < 32) steer(g, w, c, sc, side, ef, max_iters, fast, dead_ok, it);
  }
  if (tid < 32) {
    const longlong2* key = beam_of(w, side).key;
    for (int i = lane; i < ef; i += 32) {
      w.bd[i] = key[i].x;
      w.bs[i] = slot_of(key[i]);
    }
  }
  __syncthreads();  // the beam is in w.bd / w.bs; sc->step is read
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    search_kernel(const Args args, const Plan P) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ Scal sc;
  __shared__ __align__(8) uint64_t bar[2];
  __shared__ int64_t a[A_COUNT];
  for (int i = threadIdx.x; i < A_COUNT; i += blockDim.x) a[i] = args.v[i];
  __syncthreads();
  const int b = blockIdx.x / P.cluster, s = blockIdx.y;
  const int64_t B = a[A_B];
  const int64_t beam = static_cast<int64_t>(s) * B + b;
  Graph<T> g = graph_of<T>(a, s);
  Ctx c = make_ctx(P, g.dim, sizeof(T), bar);
  uint8_t* gmem = reinterpret_cast<uint8_t*>(a[A_SCRATCH]) +
                  (beam * P.cluster + c.rank) * P.gmem;
  const Work w = bind_work(P, smem, gmem);
  const int ef = static_cast<int>(a[A_EF]);
  const int kk = static_cast<int>(a[A_KK]);
  const int64_t out_base = beam * kk;
  long long* out_ids = reinterpret_cast<long long*>(a[A_OUT_IDS]) + out_base;
  long long* out_d = reinterpret_cast<long long*>(a[A_OUT_D]) + out_base;
  int32_t* out_s = reinterpret_cast<int32_t*>(a[A_OUT_S]) + out_base;

  const int32_t entry = reinterpret_cast<const int32_t*>(a[A_ENTRY])[s];
  if (entry < 0) {  // no graph: every result is missing (no rank waits)
    for (int i = threadIdx.x; c.rank == 0 && i < kk; i += blockDim.x) {
      out_ids[i] = -1;
      out_d[i] = kInf;
      out_s[i] = -1;
    }
    return;
  }
  load_valid(g, w.vmap);
  const long long* qsrc =
      reinterpret_cast<const long long*>(a[A_Q]) + b * a[A_DIM] + c.lo;
  for (int j = threadIdx.x; j < c.len; j += blockDim.x) w.q[j] = qsrc[j];
  __syncthreads();
  const int32_t entry_safe = g.clip(entry);
  const int entry_level = g.levels[entry_safe];
  int32_t cur = entry_safe;
  for (int lvl = g.max_levels - 1; lvl > 0; --lvl)
    if (lvl <= entry_level) cur = greedy(g, w, c, &sc, lvl, cur);
  search_layer(g, w, c, &sc, cur, 0, ef, static_cast<int>(a[A_MAX_ITERS]),
               false, true);
  if (c.rank == 0) {
    for (int i = threadIdx.x; i < ef; i += blockDim.x) {
      if (!(w.bd[i] < kInf && g.live(w.bs[i]))) {  // dead rows leave
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
  cluster_sync(c);  // no CTA leaves while another reads its partials
}

// _connect: new_slot's forward row to its m nearest candidates (w.cd /
// w.cs, sorted), each candidate's row pruned back to the degree with
// new_slot offered, by (distance to the owner, slot). The distance from
// new_slot to an owner is the beam's (w.cd); the owners' other distances
// are pulled over the cluster. Rank 0 writes; ends with a cluster barrier.
template <typename T>
__device__ void connect(const Graph<T>& g, const Work& w, Ctx& c, Scal* sc,
                        int lvl, int32_t new_slot, int ef, int m, bool dedup) {
  const int deg = g.degree, tid = threadIdx.x, lane = tid & 31;
  if (c.rank == 0) {
    int32_t* fwd = g.row(lvl, new_slot);
    for (int j = tid; j < deg; j += blockDim.x) {
      const int src = j < ef - 1 ? j : ef - 1;
      fwd[j] = (j < m && w.cd[src] < kInf) ? w.cs[src] : -1;
    }
  }
  const int mm = m < ef ? m : ef;
  if (tid < 32) {  // the owners, in order: a ballot and a prefix count
    int n = 0;
    for (int i0 = 0; i0 < mm; i0 += 32) {
      const int i = i0 + lane;
      const bool ok = i < mm && w.cd[i] < kInf && w.cs[i] != new_slot;
      const unsigned b = __ballot_sync(kFull, ok);
      if (ok) {
        const int p = n + __popc(b & ((1u << lane) - 1u));
        w.own[p] = w.cs[i];
        w.ownd[p] = w.cd[i];
      }
      n += __popc(b);
    }
    if (lane == 0) sc->n_own = n;
  }
  __syncthreads();
  const int n_own = sc->n_own;
  if (n_own > 0) {
    for (int t = tid; t < n_own * c.len; t += blockDim.x) {
      const int o = t / c.len, j = t - o * c.len;
      w.oref[o * c.slice + j] =
          static_cast<long long>(__ldg(g.vrow(w.own[o]) + c.lo + j));
    }
    for (int t = tid; t < n_own * deg; t += blockDim.x) {
      const int o = t / deg;
      const int32_t x = __ldcg(g.row(lvl, w.own[o]) + (t - o * deg));
      w.cur[t] = x;
      w.jslot[t] = x >= 0 ? g.clip(x) : -1;
      w.jref[t] = o;
    }
    dists(g, w, c, n_own * deg, w.oref, true, c.slice, w.td);
    const int len = deg + 1;
    if (c.rank == 0) {
      for (int t = tid; t < n_own * len; t += blockDim.x) {
        const int o = t / len, j = t - o * len;
        if (j < deg) {
          const int32_t x = w.cur[o * deg + j];
          w.bd[t] = x >= 0 ? w.td[o * deg + j] : kInf;
          w.bs[t] = x >= 0 ? x : kPad;
        } else {
          w.bd[t] = w.ownd[o];
          w.bs[t] = new_slot;
        }
      }
      if (dedup)
        block_sort_dedup(w.bd, w.bs, n_own * len, len, w.td, w.ts, w.tf);
      else
        block_sort(w.bd, w.bs, nullptr, n_own * len, len, w.td, w.ts,
                   nullptr);
      for (int t = tid; t < n_own * deg; t += blockDim.x) {
        const int o = t / deg, j = t % deg;
        const int p = o * len + j;
        g.row(lvl, w.own[o])[j] = w.bd[p] < kInf ? w.bs[p] : -1;
      }
    }
  }
  cluster_sync(c);  // rank 0's writes before any rank reads the graph
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    insert_kernel(const Args args, const Plan P) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ Scal sc;
  __shared__ __align__(8) uint64_t bar[2];
  __shared__ int64_t a[A_COUNT];
  for (int i = threadIdx.x; i < A_COUNT; i += blockDim.x) a[i] = args.v[i];
  __syncthreads();
  const int s = blockIdx.x / P.cluster;
  Graph<T> g = graph_of<T>(a, s);
  Ctx c = make_ctx(P, g.dim, sizeof(T), bar);
  uint8_t* gmem = reinterpret_cast<uint8_t*>(a[A_SCRATCH]) +
                  (static_cast<int64_t>(s) * P.cluster + c.rank) * P.gmem;
  const Work w = bind_work(P, smem, gmem);
  load_valid(g, w.vmap);
  const int ef = static_cast<int>(a[A_EF]);
  const int max_iters = static_cast<int>(a[A_MAX_ITERS]);
  const int m = static_cast<int>(a[A_M]);
  const bool fast = a[A_FAST] != 0;
  const bool lead = c.rank == 0 && threadIdx.x == 0;
  int32_t* entry_out = reinterpret_cast<int32_t*>(a[A_ENTRY]) + s;
  const int32_t* slots =
      reinterpret_cast<const int32_t*>(a[A_SLOTS]) + s * a[A_SLOTS_STRIDE];
  // every thread of every rank keeps the entry and levels[clip(entry)]
  int32_t entry = *entry_out;
  int entry_level = entry >= 0 ? __ldcg(g.levels + g.clip(entry)) : 0;
  cluster_sync(c);  // every rank has read them before rank 0 writes any
  for (int64_t i = 0; i < a[A_N_REAL]; ++i) {
    const int32_t slot = slots[i];
    if (slot < 0 || slot >= g.cap) continue;  // a sentinel: skipped
    const T* src = g.vrow(slot) + c.lo;
    for (int j = threadIdx.x; j < c.len; j += blockDim.x)
      w.q[j] = static_cast<long long>(__ldg(src + j));
    const bool is_first = entry < 0;
    const int raw_level = level_of_id(__ldg(g.ids + slot), g.max_levels);
    const int32_t e = is_first ? slot : entry;
    const int e_level = is_first ? raw_level : entry_level;
    const int node_level = raw_level < e_level ? raw_level : e_level;
    if (lead) g.levels[slot] = node_level;
    if (slot == g.clip(e)) entry_level = node_level;
    entry = e;
    __syncthreads();  // the new row's slice is in w.q
    if (is_first) continue;
    int32_t cur = e;
    for (int lvl = g.max_levels - 1; lvl > 0; --lvl)
      if (node_level < lvl && lvl <= e_level)
        cur = greedy(g, w, c, &sc, lvl, cur);
    const int top = node_level < g.max_levels - 1 ? node_level : g.max_levels - 1;
    for (int lvl = top; lvl >= 0; --lvl) {
      search_layer(g, w, c, &sc, cur, lvl, ef, max_iters, fast, false);
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
      connect(g, w, c, &sc, lvl, slot, ef, m, !fast);
      if (w.cd[0] < kInf) cur = w.cs[0];
    }
  }
  if (lead) *entry_out = entry;
  cluster_sync(c);  // no CTA leaves while another reads its partials
}

template <typename T>
cudaError_t launch_typed(const int64_t* a, const Plan& P, cudaStream_t st) {
  Args args;
  for (int i = 0; i < A_COUNT; ++i) args.v[i] = a[i];
  const bool search = a[A_OP] == 0;
  void (*kern)(const Args, const Plan) =
      search ? search_kernel<T> : insert_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(P.smem));
  if (err != cudaSuccess) return err;
  const unsigned C = static_cast<unsigned>(P.cluster);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = search ? dim3(static_cast<unsigned>(a[A_B]) * C,
                              static_cast<unsigned>(a[A_NS]))
                       : dim3(static_cast<unsigned>(a[A_NS]) * C);
  cfg.blockDim = dim3(static_cast<unsigned>(P.threads));
  cfg.dynamicSmemBytes = static_cast<size_t>(P.smem);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, args, P);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// one thread following a cycle of indices past L1: each load waits for the
// one before, so the time per step is one memory round trip
__global__ void chase_kernel(const int32_t* next, int64_t steps,
                             int32_t* sink) {
  int32_t p = 0;
  for (int64_t i = 0; i < steps; ++i) p = __ldcg(next + p);
  *sink = p;
}

}  // namespace

// Bytes of global scratch a launch needs (every CTA's share of the
// workspace that does not fit its shared memory).
extern "C" int64_t qhnsw_scratch_bytes(const int64_t* a) {
  const Plan P = make_plan(a);
  const int64_t beams = a[A_OP] == 0 ? a[A_B] * a[A_NS] : a[A_NS];
  return P.gmem * beams * P.cluster;
}

// The CTAs per beam (the cluster size) a launch with these arguments takes.
extern "C" int qhnsw_cluster(const int64_t* a) { return make_plan(a).cluster; }

// ``a`` is the argument array (enum Arg). Returns cudaGetLastError().
extern "C" int qhnsw_launch(const int64_t* a, void* stream) {
  if (a[A_NS] <= 0 || a[A_CAP] <= 0 || a[A_DIM] <= 0 || a[A_DEGREE] <= 0 ||
      a[A_LEVELS] <= 0 || a[A_EF] <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a[A_CAP] > 0x7fffffff || a[A_NS] > 65535 ||
      (a[A_OP] == 0 && (a[A_B] <= 0 || a[A_B] * kMaxCluster > 0x7fffffff)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan P = make_plan(a);
  if (P.rows < 1)  // a row slice past shared memory: not taken
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (a[A_ELEM]) {
    case 2: return static_cast<int>(launch_typed<int16_t>(a, P, st));
    case 4: return static_cast<int>(launch_typed<int32_t>(a, P, st));
    case 8: return static_cast<int>(launch_typed<long long>(a, P, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ``steps`` dependent loads of one thread through ``next`` (a cycle of
// int32 indices), for the round-trip probe. Returns cudaGetLastError().
extern "C" int qhnsw_chase(const int32_t* next, int64_t steps, int32_t* sink,
                           void* stream) {
  chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(next, steps,
                                                              sink);
  return static_cast<int>(cudaGetLastError());
}
