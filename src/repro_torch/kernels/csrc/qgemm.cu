// qgemm: exact wide integer scoring matmul for Hopper (sm_90a).
//
// out[i, j] = sum_k q[i, k] * db[j, k], int64 output, equal to the int64
// product of the rows modulo 2^64 (the reference's wrapped matmul).
// One launch function, dispatched by element type:
//
// * int16 / int32 rows — `qgemm_imma`, on the int8 tensor cores. Each
//   block owns 64 queries x 128 database rows. The database rows are the
//   wgmma A operand, taken from registers (64 rows a warpgroup, output
//   transposed on the store); the queries are the B operand (N = 64) in
//   shared memory. Depth stages of 64 values stream through a 3-deep
//   cp.async ring of raw tiles (16 bytes a thread, zero-filled past nq,
//   nn and d). Every value is cut into three 8-bit limbs,
//   v = t * 2^16 + m * 2^8 + l (t = byte 2 read as s8, m and l unsigned),
//   exact for v in [-2^23, 2^23): every boundary-normalized row, every
//   int16. Each thread splits its own A fragments in registers (byte
//   permutes), the query tile is split once per block into swizzled
//   planes, and the nine s8/u8 products accumulate into five s32 shift
//   groups (0, 8, 16, 24, 32), each exact for d <= 8192 (the largest
//   per-element sum, 2 * 128 * 255 + 255^2 in group 16, times 8192 is
//   1.07e9 < 2^31), combined into int64 (wrapping) at the store.
//   A stage in which a warpgroup's rows or the query tile hold a value
//   outside [-2^23, 2^23) (decided per warpgroup and stage) is summed on
//   the CUDA cores instead, with wrapping 64-bit multiply-adds from the
//   raw tiles, into the output itself; so every int32 stays exact.
// * int64 rows (Q32.32) — `qgemm_wide64`, on the CUDA cores: a 64 x 64
//   shared-memory tiled kernel with wrapping 64-bit multiply-adds.
//
// Rows whose byte stride is not a multiple of 16, or whose base is not
// 16-byte aligned, take plain element loads into the same ring
// (`qgemm_path` says which path a launch takes).
#include <cuda_runtime.h>
#include <stdint.h>

#include "imma.cuh"

namespace {

using namespace imma;

constexpr int kKc = 64;       // depth per stage, in values
constexpr int kQ = 64;        // queries per block (the B operand, N = 64)
constexpr int kN = 128;       // database rows per block: 64 a warpgroup
constexpr int kStages = 3;
constexpr int kThreads = 256;  // two warpgroups
constexpr int kPlane = kQ * kKc;  // one limb plane of the query tile
constexpr int kQLimbs = 3 * kPlane;  // t, m, l

template <typename T>
struct Tile {
  static constexpr int kRowBytes = kKc * sizeof(T);
  static constexpr int kStride = kRowBytes + 16;  // padded raw row
  static constexpr int kRawQ = kQ * kStride;
  static constexpr int kStage = kRawQ + kN * kStride;  // queries, then rows
  // the raw ring, two stages of query planes, and room to align to 1 KB
  static constexpr int kSmem = kStages * kStage + 2 * kQLimbs + 1024;
};

// Raw rows [r0, r0 + kRowsTile) x depth [k0, k0 + kKc) of x [nr, d] into
// a ring slot, zero past nr and d.
template <typename T, bool kAsync, int kRowsTile>
__device__ __forceinline__ void load_rows(uint8_t* dst,
                                          const T* __restrict__ x,
                                          int64_t r0, int64_t nr, int64_t d,
                                          int64_t k0, int tid) {
  constexpr int kUnits = Tile<T>::kRowBytes / 16;
  constexpr int kPer = 16 / sizeof(T);
#pragma unroll
  for (int u = tid; u < kRowsTile * kUnits; u += kThreads) {
    const int row = u / kUnits, c = u % kUnits;
    const int64_t g = r0 + row, k = k0 + c * kPer;
    uint8_t* s = dst + row * Tile<T>::kStride + c * 16;
    if constexpr (kAsync) {
      const bool in = g < nr && k < d;
      cp_async16(s, in ? x + g * d + k : x, in ? 16 : 0);
    } else {
      T* sv = reinterpret_cast<T*>(s);
#pragma unroll
      for (int e = 0; e < kPer; ++e)
        sv[e] = (g < nr && k + e < d) ? x[g * d + k + e] : T(0);
    }
  }
}

// four consecutive values of a raw row in shared memory, as int32 words
__device__ __forceinline__ uint4 load4(const int32_t* p) {
  return *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ uint4 load4(const int16_t* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  return make_uint4(static_cast<uint32_t>(static_cast<int16_t>(w.x & 0xFFFFu)),
                    static_cast<uint32_t>(static_cast<int16_t>(w.x >> 16)),
                    static_cast<uint32_t>(static_cast<int16_t>(w.y & 0xFFFFu)),
                    static_cast<uint32_t>(static_cast<int16_t>(w.y >> 16)));
}

template <typename T>
__device__ __forceinline__ void load16(const T* p, T (&v)[16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint4 w = load4(p + 4 * i);
    v[4 * i] = static_cast<T>(w.x);
    v[4 * i + 1] = static_cast<T>(w.y);
    v[4 * i + 2] = static_cast<T>(w.z);
    v[4 * i + 3] = static_cast<T>(w.w);
  }
}

// The query tile of one stage -> its t, m, l planes (one thread per 16
// values); returns whether any value lies outside [-2^23, 2^23).
template <typename T>
__device__ __forceinline__ bool split_queries(const uint8_t* raw,
                                              uint8_t* planes, int item) {
  const int row = item % kQ, chunk = item / kQ;
  T v[16];
  load16(reinterpret_cast<const T*>(raw + row * Tile<T>::kStride) + 16 * chunk,
         v);
  return split16<1>(v, planes + swz<kKc>(row, chunk), kPlane);
}

// This thread's A fragments of one 32-deep step: limbs t, m, l of the
// four register groups (rows r, r + 8 x depth bytes 4c.., 16 + 4c..);
// or-s |x| - (x < 0) of every value into `mag`.
template <typename T>
__device__ __forceinline__ void split_fragment(const uint8_t* raw, int row,
                                               int k, uint32_t (&a)[3][4],
                                               uint32_t& mag) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const T* p = reinterpret_cast<const T*>(
                     raw + (row + 8 * (j % 2)) * Tile<T>::kStride) +
                 k + 16 * (j / 2);
    const uint4 w = load4(p);
    const uint32_t x[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      mag |= x[e] ^ static_cast<uint32_t>(static_cast<int32_t>(x[e]) >> 31);
    uint32_t b[4];
    transpose4(w.x, w.y, w.z, w.w, b);
    a[0][j] = b[2];
    a[1][j] = b[1];
    a[2][j] = b[0];
  }
}

template <typename T, bool kAsync>
__global__ void __launch_bounds__(kThreads, 1)
qgemm_imma(const T* __restrict__ q, const T* __restrict__ db,
           long long* __restrict__ out, int64_t nq, int64_t nn, int64_t d) {
  extern __shared__ uint8_t smem_raw[];
  using L = Tile<T>;
  uint8_t* smem = smem_1k(smem_raw);
  uint8_t* qlimbs = smem + kStages * L::kStage;  // [stage % 2][t | m | l]
  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128;
  const int64_t q0 = static_cast<int64_t>(blockIdx.y) * kQ;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kN;
  const int nst = static_cast<int>((d + kKc - 1) / kKc);
  // this thread's fragment rows within the block's database tile
  const int frow = wg * 64 + 16 * (t / 32) + (t % 32) / 4;
  const int fk = 4 * (t % 4);

  int acc[5][32];  // shift groups 0, 8, 16, 24, 32
#pragma unroll
  for (int g = 0; g < 5; ++g)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[g][i] = 0;
  bool summed = false;  // some stage went to the CUDA cores (into `out`)

  auto load = [&](int st) {
    if (st < nst) {
      uint8_t* s = smem + (st % kStages) * L::kStage;
      load_rows<T, kAsync, kQ>(s, q, q0, nq, d, int64_t(st) * kKc, tid);
      load_rows<T, kAsync, kN>(s + L::kRawQ, db, n0, nn, d,
                               int64_t(st) * kKc, tid);
    }
    cp_async_commit();  // empty groups keep the count uniform
  };
  // stage st's query tile -> plane buffer st % 2; returns the block-wide
  // "some query value needs more than three limbs"
  auto split_q = [&](int st) {
    const uint8_t* s = smem + (st % kStages) * L::kStage;
    const bool wide = split_queries<T>(s, qlimbs + (st % 2) * kQLimbs, tid);
    fence_proxy_async();
    return __syncthreads_or(wide) != 0;
  };

  load(0);
  load(1);
  cp_async_wait<1>();
  __syncthreads();
  bool qwide = nst > 0 ? split_q(0) : false;
  for (int st = 0; st < nst; ++st) {
    load(st + 2);  // into the slot of stage st - 1, free since the barrier
    const uint8_t* raw = smem + (st % kStages) * L::kStage;
    const uint8_t* rawn = raw + L::kRawQ;
    uint32_t a[2][3][4];
    uint32_t mag = 0;
#pragma unroll
    for (int s2 = 0; s2 < kKc / 32; ++s2)
      split_fragment<T>(rawn, frow, 32 * s2 + fk, a[s2], mag);
    const bool wide = sizeof(T) == 4 && wg_any(qwide || mag >= (1u << 23), wg);
    if (!wide) {
      const uint32_t qb = smem_u32(qlimbs + (st % 2) * kQLimbs);
      wg_fence();
#pragma unroll
      for (int g = 0; g < 5; ++g) fence_regs(acc[g]);
#pragma unroll
      for (int s2 = 0; s2 < kKc / 32; ++s2) {
        const uint64_t bt = desc<kKc>(qb + 32 * s2);
        const uint64_t bm = desc<kKc>(qb + kPlane + 32 * s2);
        const uint64_t bl = desc<kKc>(qb + 2 * kPlane + 32 * s2);
        const auto& at = a[s2][0];
        const auto& am = a[s2][1];
        const auto& al = a[s2][2];
        mma_n64_rs<true, true>(acc[4], at, bt);
        mma_n64_rs<true, false>(acc[3], at, bm);
        mma_n64_rs<false, true>(acc[3], am, bt);
        mma_n64_rs<true, false>(acc[2], at, bl);
        mma_n64_rs<false, false>(acc[2], am, bm);
        mma_n64_rs<false, true>(acc[2], al, bt);
        mma_n64_rs<false, false>(acc[1], am, bl);
        mma_n64_rs<false, false>(acc[1], al, bm);
        mma_n64_rs<false, false>(acc[0], al, bl);
      }
      wg_commit();
    } else {
      // a value beyond three limbs: this stage on the CUDA cores, wrapping
      // 64-bit sums added to the output this thread owns
#pragma unroll 1
      for (int i = 0; i < 32; ++i) {
        const int r = wg * 64 + frag_row(t, i), c = frag_col(t, i);
        const T* pq = reinterpret_cast<const T*>(raw + c * L::kStride);
        const T* pn = reinterpret_cast<const T*>(rawn + r * L::kStride);
        unsigned long long sum = 0;
#pragma unroll 8
        for (int k = 0; k < kKc; ++k)
          sum += static_cast<unsigned long long>(static_cast<long long>(pq[k])) *
                 static_cast<unsigned long long>(static_cast<long long>(pn[k]));
        const int64_t gq = q0 + c, gn = n0 + r;
        if (gq < nq && gn < nn) {
          long long* o = out + gq * nn + gn;
          *o = static_cast<long long>(
              (summed ? static_cast<unsigned long long>(*o) : 0ull) + sum);
        }
      }
      summed = true;
    }
    // stage st + 1 landed; both warpgroups are past stage st - 1's products
    // and past every read of stage st - 1's slot
    cp_async_wait<1>();
    __syncthreads();
    qwide = st + 1 < nst ? split_q(st + 1) : false;
    wg_wait<0>();  // the A registers are rewritten next stage
#pragma unroll
    for (int g = 0; g < 5; ++g) fence_regs(acc[g]);
#pragma unroll
    for (int s2 = 0; s2 < kKc / 32; ++s2)
#pragma unroll
      for (int l = 0; l < 3; ++l) fence_regs(a[s2][l]);  // live until here
  }

  // D is [database row, query]: register i of thread t holds row
  // frag_row(t, i) of this warpgroup's 64 and query frag_col(t, i)
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int64_t gn = n0 + wg * 64 + frag_row(t, i);
    const int64_t gq = q0 + frag_col(t, i);
    if (gq < nq && gn < nn) {
      unsigned long long v = 0;
#pragma unroll
      for (int g = 0; g < 5; ++g)
        v += static_cast<unsigned long long>(static_cast<long long>(acc[g][i]))
             << (8 * g);
      long long* o = out + gq * nn + gn;
      *o = static_cast<long long>(
          (summed ? static_cast<unsigned long long>(*o) : 0ull) + v);
    }
  }
}

// int64 rows: 64 x 64 output tile per block, depth steps of 32, a 4 x 4
// register tile of wrapping 64-bit multiply-adds per thread
constexpr int kRows = 64, kWBK = 32, kWT = 4;
constexpr int kWRowsPerStep = kThreads / kWBK;

__global__ void __launch_bounds__(kThreads)
qgemm_wide64(const int64_t* __restrict__ q, const int64_t* __restrict__ db,
             long long* __restrict__ out, int64_t nq, int64_t nn, int64_t d) {
  __shared__ int64_t qs[kWBK][kRows + 1];  // [k][row], padded
  __shared__ int64_t ds[kWBK][kRows + 1];
  const int tid = threadIdx.x;
  const int tq = tid / (kRows / kWT), tn = tid % (kRows / kWT);
  const int64_t q0 = static_cast<int64_t>(blockIdx.y) * kRows;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int lc = tid % kWBK, lr = tid / kWBK;

  unsigned long long acc[kWT][kWT];
#pragma unroll
  for (int i = 0; i < kWT; ++i)
#pragma unroll
    for (int j = 0; j < kWT; ++j) acc[i][j] = 0;

  for (int64_t k0 = 0; k0 < d; k0 += kWBK) {
    const int64_t gk = k0 + lc;
#pragma unroll
    for (int r = lr; r < kRows; r += kWRowsPerStep) {
      const int64_t gq = q0 + r, gn = n0 + r;
      qs[lc][r] = (gq < nq && gk < d) ? q[gq * d + gk] : 0;
      ds[lc][r] = (gn < nn && gk < d) ? db[gn * d + gk] : 0;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kWBK; ++kk) {
      unsigned long long a[kWT], b[kWT];
#pragma unroll
      for (int i = 0; i < kWT; ++i) {
        a[i] = static_cast<unsigned long long>(qs[kk][tq + 16 * i]);
        b[i] = static_cast<unsigned long long>(ds[kk][tn + 16 * i]);
      }
#pragma unroll
      for (int i = 0; i < kWT; ++i)
#pragma unroll
        for (int j = 0; j < kWT; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kWT; ++i) {
    const int64_t gq = q0 + tq + 16 * i;
    if (gq >= nq) continue;
#pragma unroll
    for (int j = 0; j < kWT; ++j) {
      const int64_t gn = n0 + tn + 16 * j;
      if (gn < nn) out[gq * nn + gn] = static_cast<long long>(acc[i][j]);
    }
  }
}

template <typename T, bool kAsync>
cudaError_t launch_imma(const void* q, const void* db, long long* out,
                        int64_t nq, int64_t nn, int64_t d, cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      qgemm_imma<T, kAsync>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Tile<T>::kSmem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(static_cast<unsigned>((nn + kN - 1) / kN),
                  static_cast<unsigned>((nq + kQ - 1) / kQ));
  qgemm_imma<T, kAsync><<<grid, kThreads, Tile<T>::kSmem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(db), out, nq, nn, d);
  return cudaGetLastError();
}

}  // namespace

// The path a launch takes: 2 = CUDA cores (int64 rows), 1 = tensor cores
// with cp.async loads, 0 = tensor cores with plain loads.
extern "C" int qgemm_path(const void* q, const void* db, int64_t d, int elem) {
  if (elem == 8) return 2;
  const bool aligned = (d * elem) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(db) % 16 == 0;
  return aligned ? 1 : 0;
}

// q [nq, d] and db [nn, d] of one integer type of `elem` bytes (2, 4 or
// 8), out int64 [nq, nn]. Returns cudaGetLastError() after the launch.
extern "C" int qgemm_launch(const void* q, const void* db, long long* out,
                            int64_t nq, int64_t nn, int64_t d, int elem,
                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nq <= 0 || nn <= 0) return static_cast<int>(cudaGetLastError());
  const int path = qgemm_path(q, db, d, elem);
  if (path == 2) {
    const dim3 grid(static_cast<unsigned>((nn + kRows - 1) / kRows),
                    static_cast<unsigned>((nq + kRows - 1) / kRows));
    qgemm_wide64<<<grid, kThreads, 0, s>>>(static_cast<const int64_t*>(q),
                                           static_cast<const int64_t*>(db),
                                           out, nq, nn, d);
    return static_cast<int>(cudaGetLastError());
  }
  cudaError_t err;
  if (elem == 4)
    err = path ? launch_imma<int32_t, true>(q, db, out, nq, nn, d, s)
               : launch_imma<int32_t, false>(q, db, out, nq, nn, d, s);
  else if (elem == 2)
    err = path ? launch_imma<int16_t, true>(q, db, out, nq, nn, d, s)
               : launch_imma<int16_t, false>(q, db, out, nq, nn, d, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
