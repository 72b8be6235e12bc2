// qtopk: deterministic k smallest (int64 score, int32 key) per row, by
// exact radix selection, for Hopper (sm_90a).
//
// Each pair becomes a 96-bit composite key: (uint64)score ^ 2^63 in the
// top 64 bits, (uint32)key ^ 2^31 in the low 32, so that unsigned order
// of the composite is (score, key) order. Keys are unique within a row,
// so the kt smallest composites are one exact set, and the reference's
// tie rule (smallest key among equal scores) holds by construction.
//
// One block selects the kt = min(k, L) smallest of a segment of L pairs
// of one row: it finds the kt-th smallest composite by MSB radix select
// (8-bit digits, a 256-bin shared histogram per digit, warp 0 scans the
// bins and names the one that holds the kt-th key), starting at the
// highest bit on which the keys still in play differ (their AND and OR,
// taken before the first digit and after each chosen bin, so no pass is
// spent on bits they share: a row of INF, equal scores) and stopping as
// soon as the chosen bin holds exactly what is still needed. The number
// of passes depends on the bits of the data, never on k. A segment held
// in registers marks each slot with two bits (still in play; below the
// chosen bin), and a warp with nothing in play skips a pass's slots. The
// kt selected pairs are compacted by a block prefix sum.
//
// Two instantiations: the tile block (256 threads x 16 keys in registers
// = 4096 columns; phase 1: one block per (4096-column tile, row), its kt
// pairs written unordered) and the row block (1024 threads x 8 keys: one
// block per row; phase 2 over the tiles' candidates, or the only pass
// where a row is one tile or k >= 4096). The row block sorts up to 2048
// selected pairs in shared memory (bitonic) and writes them in order; a
// longer selection is left to the caller's sort. A segment longer than a
// block's registers is streamed from memory once per pass.
//
// Scores must be < INT64_MAX for the result to equal the reference's: its
// retire rule cannot tell such a score from a retired lane (here it is an
// ordinary value).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;
constexpr unsigned kFull = 0xffffffffu;

struct Key {
  u64 hi;       // (uint64)score ^ 2^63
  unsigned lo;  // (uint32)key ^ 2^31
};

__device__ __forceinline__ Key make_key(long long s, int32_t k) {
  return {static_cast<u64>(s) ^ (1ull << 63),
          static_cast<unsigned>(k) ^ 0x80000000u};
}
__device__ __forceinline__ long long key_score(Key x) {
  return static_cast<long long>(x.hi ^ (1ull << 63));
}
__device__ __forceinline__ int32_t key_key(Key x) {
  return static_cast<int32_t>(x.lo ^ 0x80000000u);
}
__device__ __forceinline__ bool key_le(Key a, Key b) {
  return a.hi < b.hi || (a.hi == b.hi && a.lo <= b.lo);
}
// the low m bits set, 0 <= m <= 96
__device__ __forceinline__ Key ones(int m) {
  if (m <= 32) return {0ull, m == 32 ? kFull : (1u << m) - 1u};
  return {m == 96 ? ~0ull : (1ull << (m - 32)) - 1ull, kFull};
}
// bits [s, s + 8) of x, 0 <= s <= 88
__device__ __forceinline__ unsigned digit(Key x, int s) {
  if (s >= 32) return static_cast<unsigned>(x.hi >> (s - 32)) & 0xffu;
  if (s <= 24) return (x.lo >> s) & 0xffu;
  return (static_cast<unsigned>(x.hi << (32 - s)) | (x.lo >> s)) & 0xffu;
}
// b << s, 0 <= b < 256, 0 <= s <= 88
__device__ __forceinline__ Key shl_digit(unsigned b, int s) {
  if (s >= 32) return {static_cast<u64>(b) << (s - 32), 0u};
  if (s <= 24) return {0ull, b << s};
  return {static_cast<u64>(b >> (32 - s)), b << s};
}
// the highest set bit of x, or -1
__device__ __forceinline__ int top_bit(Key x) {
  if (x.hi) return 95 - __clzll(static_cast<long long>(x.hi));
  if (x.lo) return 31 - __clz(static_cast<int>(x.lo));
  return -1;
}

// one key into the digit histogram; every lane of the warp calls it. The
// lanes that carry the first live lane's digit add once, together (a
// row of equal scores or INF puts a whole warp on one bin); the others
// add alone.
__device__ __forceinline__ void hist_add(unsigned* hist, bool live,
                                         unsigned d, int lane) {
  const unsigned lm = __ballot_sync(kFull, live);
  if (lm == 0) return;
  const int first = __ffs(lm) - 1;
  const unsigned d0 = __shfl_sync(kFull, d, first);
  const unsigned same = __ballot_sync(kFull, live && d == d0);
  if (live && d != d0) atomicAdd(&hist[d], 1u);
  if (lane == first) atomicAdd(&hist[d0], static_cast<unsigned>(__popc(same)));
}

template <int kThreads, int kSortMax>
struct Smem {
  static constexpr int kWarps = kThreads / 32;
  unsigned hist[256];
  u64 and_hi[kWarps], or_hi[kWarps];
  unsigned and_lo[kWarps], or_lo[kWarps];
  int warp_count[kWarps];
  int bin, before, count;
  u64 sort_hi[kSortMax > 0 ? kSortMax : 1];
  unsigned sort_lo[kSortMax > 0 ? kSortMax : 1];
};

// Block kernel: selects the kt = min(k, L) smallest pairs of a segment
// (see the file note). With `sort` (kSortMax > 0, kt <= kSortMax) the kt
// pairs leave in (score, key) order, by a bitonic sort in shared memory.
template <int kThreads, int kItems, int kMinBlocks, int kSortMax>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
select_kernel(const long long* __restrict__ scores, int64_t s_stride,
              const int32_t* __restrict__ keys, int64_t k_stride,
              int64_t len, int64_t seg, int k, long long* __restrict__ out_s,
              int32_t* __restrict__ out_k, int64_t out_stride,
              int64_t out_seg_stride, int sort) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kChunk = kThreads * kItems;
  __shared__ Smem<kThreads, kSortMax> sm;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t row = blockIdx.y;
  const int64_t begin = static_cast<int64_t>(blockIdx.x) * seg;
  const int64_t L = len - begin < seg ? len - begin : seg;
  const int kt = L < k ? static_cast<int>(L) : k;
  const long long* srow = scores + row * s_stride + begin;
  const int32_t* krow = keys + row * k_stride + begin;
  long long* os = out_s + row * out_stride + blockIdx.x * out_seg_stride;
  int32_t* ok = out_k + row * out_stride + blockIdx.x * out_seg_stride;

  // A segment that fits is loaded once, and its slots carry two bit masks
  // (live: still in play; sel: below the threshold's bin). A longer one
  // is streamed in chunks of kChunk once per pass, and a key is in play
  // while it lies in [lo_b, hi_b].
  Key reg[kItems];
  const bool resident = L <= kChunk;
  auto load = [&](int64_t base) {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int64_t i = base + threadIdx.x + static_cast<int64_t>(j) * kThreads;
      reg[j] = i < L ? make_key(srow[i], krow[i]) : Key{~0ull, kFull};
    }
  };
  // f(key, slot, in_segment) for every slot, called by all lanes alike
  auto visit = [&](auto&& f) {
    for (int64_t base = 0; base < L; base += kChunk) {
      if (!resident) load(base);
#pragma unroll
      for (int j = 0; j < kItems; ++j)
        f(reg[j], j,
          base + threadIdx.x + static_cast<int64_t>(j) * kThreads < L);
    }
  };
  unsigned in_mask = 0;
  if (resident) {
    load(0);
#pragma unroll
    for (int j = 0; j < kItems; ++j)
      if (threadIdx.x + static_cast<int64_t>(j) * kThreads < L) in_mask |= 1u << j;
  }

  // the AND and OR of the keys given by each thread, over the block
  auto block_and_or = [&](Key& a, Key& o) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      a.hi &= __shfl_xor_sync(kFull, a.hi, off);
      a.lo &= __shfl_xor_sync(kFull, a.lo, off);
      o.hi |= __shfl_xor_sync(kFull, o.hi, off);
      o.lo |= __shfl_xor_sync(kFull, o.lo, off);
    }
    if (lane == 0) {
      sm.and_hi[warp] = a.hi;
      sm.and_lo[warp] = a.lo;
      sm.or_hi[warp] = o.hi;
      sm.or_lo[warp] = o.lo;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      a = {a.hi & sm.and_hi[w], a.lo & sm.and_lo[w]};
      o = {o.hi | sm.or_hi[w], o.lo | sm.or_lo[w]};
    }
  };

  // 1. the bits all keys share: block AND / OR
  Key a{~0ull, kFull}, o{0ull, 0u};
  visit([&](Key x, int, bool in) {
    if (in) {
      a = {a.hi & x.hi, a.lo & x.lo};
      o = {o.hi | x.hi, o.lo | x.lo};
    }
  });
  for (int b = threadIdx.x; b < 256; b += kThreads) sm.hist[b] = 0;
  block_and_or(a, o);

  // 2. the threshold: the kt selected keys are those <= thr (streamed),
  // or the slots in sel | live (resident). The keys in play are those in
  // [lo_b, hi_b]: they share every bit above their highest differing bit
  // `top`, and the next digit ends at `top`.
  Key thr{~0ull, kFull};
  unsigned live = in_mask, sel = 0;
  if (kt < L) {
    Key lo_b, hi_b;
    int s;
    auto jump = [&]() {  // from the AND / OR of the keys in play
      const int top = top_bit(Key{a.hi ^ o.hi, a.lo ^ o.lo});
      const Key m = ones(top + 1);
      lo_b = {a.hi & ~m.hi, a.lo & ~m.lo};
      hi_b = {lo_b.hi | m.hi, lo_b.lo | m.lo};
      s = max(top - 7, 0);
    };
    jump();
    int needed = kt;
    for (;;) {
      // histogram of digit s over the keys in play
      if (resident) {
        if (__any_sync(kFull, live != 0)) {
#pragma unroll
          for (int j = 0; j < kItems; ++j)
            hist_add(sm.hist, (live >> j) & 1u, digit(reg[j], s), lane);
        }
      } else {
        visit([&](Key x, int, bool in) {
          const bool l = in && key_le(lo_b, x) && key_le(x, hi_b);
          hist_add(sm.hist, l, digit(x, s), lane);
        });
      }
      __syncthreads();
      if (warp == 0) {  // the bin of the needed-th key; clears the bins
        unsigned c[8], sum = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          c[j] = sm.hist[lane * 8 + j];
          sm.hist[lane * 8 + j] = 0;
          sum += c[j];
        }
        unsigned incl = sum;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const unsigned t = __shfl_up_sync(kFull, incl, off);
          if (lane >= off) incl += t;
        }
        unsigned run = incl - sum;
        if (run < static_cast<unsigned>(needed) &&
            static_cast<unsigned>(needed) <= incl) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (run + c[j] >= static_cast<unsigned>(needed)) {
              sm.bin = lane * 8 + j;
              sm.before = static_cast<int>(run);
              sm.count = static_cast<int>(c[j]);
              break;
            }
            run += c[j];
          }
        }
      }
      __syncthreads();
      const unsigned bin = static_cast<unsigned>(sm.bin);
      const int count = sm.count;
      needed -= sm.before;
      const Key m = ones(s + 8);
      const Key dig = shl_digit(bin, s);
      lo_b = {(lo_b.hi & ~m.hi) | dig.hi, (lo_b.lo & ~m.lo) | dig.lo};
      const Key f = ones(s);
      hi_b = {lo_b.hi | f.hi, lo_b.lo | f.lo};
      // the bin's keys stay in play, those below it are selected
      a = {~0ull, kFull};
      o = {0ull, 0u};
      if (resident) {
        if (live) {
#pragma unroll
          for (int j = 0; j < kItems; ++j) {
            if ((live >> j) & 1u) {
              const unsigned d = digit(reg[j], s);
              if (d < bin) sel |= 1u << j;
              if (d != bin) {
                live &= ~(1u << j);
              } else {
                a = {a.hi & reg[j].hi, a.lo & reg[j].lo};
                o = {o.hi | reg[j].hi, o.lo | reg[j].lo};
              }
            }
          }
        }
      }
      // unique keys: the bin of a whole key (s == 0) holds one
      if (count == needed || s == 0) break;
      if (!resident) {
        visit([&](Key x, int, bool in) {
          if (in && key_le(lo_b, x) && key_le(x, hi_b)) {
            a = {a.hi & x.hi, a.lo & x.lo};
            o = {o.hi | x.hi, o.lo | x.lo};
          }
        });
      }
      block_and_or(a, o);
      jump();
    }
    thr = hi_b;
  }
  const unsigned chosen = sel | live;

  // 3. compaction: a block prefix sum of each thread's count of selected
  // keys gives each its place (in the sort buffer, or in the output)
  int mine = 0;
  if (resident)
    mine = __popc(chosen);
  else
    visit([&](Key x, int, bool in) { mine += (in && key_le(x, thr)) ? 1 : 0; });
  int incl = mine;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += t;
  }
  if (lane == 31) sm.warp_count[warp] = incl;
  __syncthreads();
  int pos = incl - mine;
  for (int w = 0; w < warp; ++w) pos += sm.warp_count[w];
  const bool to_smem = kSortMax > 0 && sort;
  auto put = [&](Key x) {
    if (pos < kt) {  // holds for unique keys; guards the buffer if not
      if (to_smem) {
        sm.sort_hi[pos] = x.hi;
        sm.sort_lo[pos] = x.lo;
      } else {
        os[pos] = key_score(x);
        ok[pos] = key_key(x);
      }
    }
    ++pos;
  };
  if (resident) {
#pragma unroll
    for (int j = 0; j < kItems; ++j)
      if ((chosen >> j) & 1u) put(reg[j]);
  } else {
    visit([&](Key x, int, bool in) {
      if (in && key_le(x, thr)) put(x);
    });
  }
  if (!to_smem) return;

  // 4. bitonic sort of the kt pairs (padded to a power of two with the
  // largest key) in shared memory, then out in order
  int p2 = 1;
  while (p2 < kt) p2 <<= 1;
  for (int i = kt + threadIdx.x; i < p2; i += kThreads) {
    sm.sort_hi[i] = ~0ull;
    sm.sort_lo[i] = kFull;
  }
  for (int size = 2; size <= p2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int t = threadIdx.x; t < p2 / 2; t += kThreads) {
        const int i = 2 * t - (t & (stride - 1)), j = i + stride;
        const Key x{sm.sort_hi[i], sm.sort_lo[i]};
        const Key y{sm.sort_hi[j], sm.sort_lo[j]};
        if (key_le(y, x) == ((i & size) == 0)) {  // keys are unique
          sm.sort_hi[i] = y.hi;
          sm.sort_lo[i] = y.lo;
          sm.sort_hi[j] = x.hi;
          sm.sort_lo[j] = x.lo;
        }
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kt; i += kThreads) {
    const Key x{sm.sort_hi[i], sm.sort_lo[i]};
    os[i] = key_score(x);
    ok[i] = key_key(x);
  }
}

constexpr int kTileThreads = 256, kTileItems = 16;  // 4096 columns
constexpr int kRowThreads = 1024, kRowItems = 8;    // 8192 in registers
constexpr int kSortMax = 2048;

}  // namespace

// One launch: rows [nq], each of `len` pairs (scores at s_stride, keys at
// k_stride: 0 for keys shared by every row), cut into segments of `seg`;
// segment g of row r writes its min(k, length) pairs from
// out + r * out_stride + g * out_seg_stride, unordered, or in order with
// `sort`. `tile` picks the 256-thread block (seg <= 4096, no sort), else
// the 1024-thread one (sort needs min(k, seg) <= 2048).
extern "C" int qtopk_launch(const long long* scores, const int32_t* keys,
                            int64_t s_stride, int64_t k_stride, int64_t nq,
                            int64_t len, int64_t seg, int k,
                            long long* out_s, int32_t* out_k,
                            int64_t out_stride, int64_t out_seg_stride,
                            int tile, int sort, void* stream) {
  if (nq <= 0 || len <= 0 || seg <= 0 || k <= 0) return 0;
  if (tile && (seg > kTileThreads * kTileItems || sort))
    return static_cast<int>(cudaErrorInvalidValue);
  if (sort && (seg < k ? seg : k) > kSortMax)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_segs = (len + seg - 1) / seg;
  if (n_segs > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int64_t r0 = 0; r0 < nq; r0 += 65535) {  // grid.y limit
    const int64_t rows = nq - r0 < 65535 ? nq - r0 : 65535;
    const dim3 grid(static_cast<unsigned>(n_segs), static_cast<unsigned>(rows));
    const long long* s = scores + r0 * s_stride;
    const int32_t* kp = keys + r0 * k_stride;
    long long* os = out_s + r0 * out_stride;
    int32_t* ok = out_k + r0 * out_stride;
    if (tile)
      select_kernel<kTileThreads, kTileItems, 3, 0>
          <<<grid, kTileThreads, 0, st>>>(s, s_stride, kp, k_stride, len, seg,
                                          k, os, ok, out_stride,
                                          out_seg_stride, 0);
    else
      select_kernel<kRowThreads, kRowItems, 1, kSortMax>
          <<<grid, kRowThreads, 0, st>>>(s, s_stride, kp, k_stride, len, seg,
                                         k, os, ok, out_stride,
                                         out_seg_stride, sort);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
