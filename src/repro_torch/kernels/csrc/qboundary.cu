// qboundary: the fused determinism boundary for Hopper (sm_90a).
//
// Replaces _qboundary_kernel of src/repro/kernels/qboundary/kernel.py:29
// (the Pallas TPU kernel). float32 [n, d] -> int32 [n, d]: Q-encode (round
// half away from zero, clamp, saturating convert, NaN -> 0), then for
// unit_norm the exact integer L2 normalization: int64 sum of squares
// (wrapping), integer floor square root, and (raw << frac_bits) / norm
// rounded half away from zero; a row whose norm is 0 passes through.
//
// What bounds it: bytes. Each element is read once (4 bytes) and written
// once (4 bytes) with a few dozen integer and float operations; at
// [512, 2304] that is 9.4 MB, 2.8 us at 3.35 TB/s. What the design does:
//
// * One block per row keeps the row in registers from the encode through
//   the sum of squares to the division: one read and one write per
//   element, nothing read back from out.
// * 16-byte loads and stores (float4 in, int4 out) when d % 4 == 0 and
//   both row bases are 16-byte aligned; otherwise the same kernel loads
//   and stores single values (coalesced). Each thread holds kPer groups of
//   four values (kPer in 1, 2, 4, 8, a template argument picked at launch:
//   the fewest that keep the block within 1024 threads). At d = 2304 that
//   is 576 threads x 1 group: faster at [64, 2304] than 288 x 2, and one
//   block per row faster than a cluster of two sharing the row through
//   distributed shared memory (PERF.md, section 6).
// * Rows wider than 1024 threads x 8 groups (32768 values) take a looped
//   two-pass kernel that encodes each value twice (right, not fast).
// * One reciprocal per row instead of a 64-bit divide per element (below),
//   for every contract with int_bits + 2 frac_bits <= 51; beyond it, an
//   exact 64-bit divide per element in a separate template instance.
// * The floor square root is one correctly rounded double sqrt and one
//   exact integer correction step, instead of a 32-step recurrence.
//
// Every float32 step of the encode is a separately rounded intrinsic
// (__fmul_rn, __fadd_rn, floorf), so nothing contracts into an FMA; the
// library is also built with -fmad=false.
//
// The division. For a = |raw| << f and a row norm N >= 1, the kernel takes
// inv = RN(1 / N) (__drcp_rn) once per row and per element
//   q0 = trunc(RN(double(a) * inv)),  rem = a - q0 * N,
// steps q0 once down if rem < 0 or once up if rem >= N, and rounds half
// away from zero on the exact remainder: mag = q0 + (2 * rem >= N).
// Why one step each way is enough: double(a) is exact for a < 2^53, and
// the two roundings give RN(a * inv) = (a / N)(1 + e), |e| <= 2^-52 +
// 2^-106, so the product is within (a / N) 2^-52 (1 + 2^-53) <= a 2^-52
// (1 + 2^-53) of a / N. For an int32 contract |raw| <= 2^(int_bits +
// frac_bits), so a <= 2^(int_bits + 2 frac_bits): below 2^52 whenever
// int_bits + 2 frac_bits <= 51 (Q16.16: 47, an error of at most 2^-5),
// and then the error is below 1 and q0 is q - 1, q or q + 1 for the true
// quotient q. A contract beyond that bound (Q4.27: 58, Q1.30: 61; an int32
// contract reaches at most 62, so a < 2^63) takes the wide instance
// (kWide, from QbParams.wide): one exact unsigned 64-bit divide per
// element, q = a / N and rem = a - q N, then the same rounding.
//
// The square root. For a sum s in [1, 2^63): double(s) and the sqrt each
// round once, so r = trunc(sqrt_rn(double(s))) is within 1.5 * 2^-53 *
// 2^31.5 < 2^-20 of sqrt(s) before truncation, hence floor(sqrt(s)) - 1,
// itself or itself + 1, and r * r < 2^63. One test each way (r * r > s;
// s - r * r >= 2r + 1) lands it exactly, with no 64-bit overflow. A sum
// that wrapped negative, and s = 0, give 0, as the reference's recurrence.
//
// The CPU model of this arithmetic, step for step, is
// kernels/qboundary/ref.py (qboundary_model): edit the two together.
#include <cuda_runtime.h>
#include <stdint.h>

// The launch constants of one (contract, unit_norm), built once by the
// wrapper (kernel.py: QbParams has the same layout).
struct QbParams {
  float one, lo, hi;
  int frac_bits;
  long long min_raw, max_raw;
  int unit_norm;
  int per_thread;  // groups of four values a thread holds; 0: chosen here
  int wide;        // unit_norm beyond the reciprocal's bound: exact divide
};

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxPer = 8;
constexpr int kLoopThreads = 1024;

enum Path { kScalar = 0, kVector = 1, kLooped = 2 };

__device__ __forceinline__ int32_t encode_one(float x, const QbParams& p) {
  const float scaled = __fmul_rn(x, p.one);
  if (isnan(scaled)) return 0;  // NaN converts to 0
  const float r = floorf(__fadd_rn(fabsf(scaled), 0.5f));
  float s = scaled > 0.f ? r : (scaled < 0.f ? -r : 0.f);  // sign * floor
  s = fminf(fmaxf(s, p.lo), p.hi);
  // saturating convert: hi may be float32(2^31 - 1) == 2^31
  if (s >= 2147483648.0f) return INT32_MAX;
  if (s < -2147483648.0f) return INT32_MIN;
  return static_cast<int32_t>(s);
}

__device__ __forceinline__ unsigned long long square(int32_t r) {
  const long long w = r;
  return static_cast<unsigned long long>(w * w);  // wraps like int64
}

// floor(sqrt(s)) for s < 2^63; 0 for s <= 0 (a wrapped sum).
__device__ __forceinline__ long long isqrt_s64(long long s) {
  if (s <= 0) return 0;
  long long r = static_cast<long long>(__dsqrt_rn(__ll2double_rn(s)));
  if (r * r > s) {
    --r;
  } else if (s - r * r >= 2 * r + 1) {
    ++r;
  }
  return r;
}

// (r << frac_bits) / norm rounded half away from zero, clamped; norm >= 1
// and inv = RN(1 / norm) (unused by the wide instance).
template <bool kWide>
__device__ __forceinline__ int32_t divide_one(int32_t r, long long norm,
                                              double inv, const QbParams& p) {
  const long long num = static_cast<long long>(r) * (1LL << p.frac_bits);
  const long long a = num < 0 ? -num : num;
  long long q, rem;
  if constexpr (kWide) {
    q = static_cast<long long>(static_cast<unsigned long long>(a) /
                               static_cast<unsigned long long>(norm));
    rem = a - q * norm;
  } else {
    q = static_cast<long long>(__dmul_rn(__ll2double_rn(a), inv));
    rem = a - q * norm;
    if (rem < 0) {
      --q;
      rem += norm;
    } else if (rem >= norm) {
      ++q;
      rem -= norm;
    }
  }
  const long long mag = q + ((2 * rem >= norm) ? 1 : 0);
  long long v = num < 0 ? -mag : mag;
  v = v < p.min_raw ? p.min_raw : (v > p.max_raw ? p.max_raw : v);
  return static_cast<int32_t>(v);
}

struct RowNorm {
  long long norm;
  double inv;  // RN(1 / norm); unused when norm == 0
};

// The row's norm from each thread's share of its sum of squares: warp
// shuffles, then one thread over the warps' sums, isqrt and the
// reciprocal. Unsigned sums wrap mod 2^64 in any order, as the int64
// reference does.
__device__ RowNorm row_norm(unsigned long long sq) {
  __shared__ unsigned long long warp_sums[kMaxThreads / 32];
  __shared__ RowNorm result;
  for (int off = 16; off > 0; off >>= 1)
    sq += __shfl_down_sync(0xffffffffu, sq, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = sq;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long tot = 0;
    for (unsigned w = 0; w < blockDim.x / 32; ++w) tot += warp_sums[w];
    const long long norm = isqrt_s64(static_cast<long long>(tot));
    result = RowNorm{norm, norm ? __drcp_rn(static_cast<double>(norm)) : 0.0};
  }
  __syncthreads();
  return result;
}

// One row per block. Thread t holds groups t, t + blockDim, ...: kPer
// float4 groups (kVec) or 4 * kPer single values; kWide divides exactly.
template <int kPer, bool kVec, bool kWide>
__global__ void __launch_bounds__(kMaxThreads)
qboundary_rows(const float* __restrict__ x, int32_t* __restrict__ out,
               int64_t d, QbParams p) {
  constexpr int kVals = 4 * kPer;
  constexpr int kStep = kVec ? kPer : kVals;
  const float* xr = x + static_cast<int64_t>(blockIdx.x) * d;
  int32_t* orow = out + static_cast<int64_t>(blockIdx.x) * d;
  const int64_t end = kVec ? d / 4 : d;  // float4 groups or values

  int32_t r[kVals];
#pragma unroll
  for (int i = 0; i < kStep; ++i) {
    const int64_t u = threadIdx.x + static_cast<int64_t>(i) * blockDim.x;
    if constexpr (kVec) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (u < end) v = reinterpret_cast<const float4*>(xr)[u];
      r[4 * i] = encode_one(v.x, p);
      r[4 * i + 1] = encode_one(v.y, p);
      r[4 * i + 2] = encode_one(v.z, p);
      r[4 * i + 3] = encode_one(v.w, p);
    } else {
      r[i] = u < end ? encode_one(xr[u], p) : 0;
    }
  }

  if (p.unit_norm) {  // uniform across the launch
    unsigned long long sq = 0;
#pragma unroll
    for (int i = 0; i < kVals; ++i) sq += square(r[i]);  // padding adds 0
    const RowNorm nm = row_norm(sq);
    if (nm.norm != 0) {
#pragma unroll
      for (int i = 0; i < kVals; ++i)
        r[i] = divide_one<kWide>(r[i], nm.norm, nm.inv, p);
    }
  }

#pragma unroll
  for (int i = 0; i < kStep; ++i) {
    const int64_t u = threadIdx.x + static_cast<int64_t>(i) * blockDim.x;
    if (u < end) {
      if constexpr (kVec) {
        reinterpret_cast<int4*>(orow)[u] =
            make_int4(r[4 * i], r[4 * i + 1], r[4 * i + 2], r[4 * i + 3]);
      } else {
        orow[u] = r[i];
      }
    }
  }
}

// Rows too wide for the registers: encode and sum, then encode again and
// divide. One block per row, single-value loads.
template <bool kWide>
__global__ void __launch_bounds__(kLoopThreads)
qboundary_looped(const float* __restrict__ x, int32_t* __restrict__ out,
                 int64_t d, QbParams p) {
  const int64_t row = blockIdx.x;
  const float* xr = x + row * d;
  int32_t* orow = out + row * d;
  RowNorm nm{0, 0.0};
  if (p.unit_norm) {
    unsigned long long sq = 0;
    for (int64_t j = threadIdx.x; j < d; j += blockDim.x)
      sq += square(encode_one(xr[j], p));
    nm = row_norm(sq);
  }
  for (int64_t j = threadIdx.x; j < d; j += blockDim.x) {
    const int32_t r = encode_one(xr[j], p);
    orow[j] = nm.norm != 0 ? divide_one<kWide>(r, nm.norm, nm.inv, p) : r;
  }
}

// The launch plan: path, groups per thread, threads per block.
struct Plan {
  int path, per, threads;
};

Plan plan_of(const void* x, const void* out, int64_t d, const QbParams& p) {
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int64_t groups = (d + 3) / 4;
  int per = 0;
  if (p.per_thread > 0) {
    per = p.per_thread;
  } else {
    for (int k = 1; k <= kMaxPer && per == 0; k *= 2)
      if ((groups + k - 1) / k <= kMaxThreads) per = k;
  }
  const int64_t threads = per ? (groups + per - 1) / per : 0;
  if (per == 0 || threads > kMaxThreads) return Plan{kLooped, 0, kLoopThreads};
  return Plan{vec ? kVector : kScalar, per,
              static_cast<int>((threads + 31) / 32 * 32)};
}

template <bool kVec, bool kWide>
cudaError_t launch_rows(const Plan& pl, const float* x, int32_t* out,
                        int64_t n, int64_t d, const QbParams& p,
                        cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(n)), block(pl.threads);
  switch (pl.per) {
    case 1: qboundary_rows<1, kVec, kWide><<<grid, block, 0, s>>>(x, out, d, p); break;
    case 2: qboundary_rows<2, kVec, kWide><<<grid, block, 0, s>>>(x, out, d, p); break;
    case 4: qboundary_rows<4, kVec, kWide><<<grid, block, 0, s>>>(x, out, d, p); break;
    case 8: qboundary_rows<8, kVec, kWide><<<grid, block, 0, s>>>(x, out, d, p); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

template <bool kWide>
cudaError_t launch_plan(const Plan& pl, const float* x, int32_t* out,
                        int64_t n, int64_t d, const QbParams& p,
                        cudaStream_t s) {
  if (pl.path == kLooped) {
    qboundary_looped<kWide><<<static_cast<unsigned>(n), kLoopThreads, 0, s>>>(
        x, out, d, p);
    return cudaSuccess;
  }
  return pl.path == kVector ? launch_rows<true, kWide>(pl, x, out, n, d, p, s)
                            : launch_rows<false, kWide>(pl, x, out, n, d, p, s);
}

}  // namespace

// The plan for these operands, written to plan[3] = {path (0 scalar loads,
// 1 16-byte loads, 2 looped), groups of four values per thread, threads}.
extern "C" int qboundary_plan(const void* x, const void* out, int64_t d,
                              const QbParams* p, int* plan) {
  const Plan pl = plan_of(x, out, d, *p);
  plan[0] = pl.path;
  plan[1] = pl.per;
  plan[2] = pl.threads;
  return 0;
}

extern "C" int qboundary_launch(const float* x, int32_t* out, int64_t n,
                                int64_t d, const QbParams* p, void* stream) {
  if (n <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan pl = plan_of(x, out, d, *p);
  const cudaError_t err = p->wide
                              ? launch_plan<true>(pl, x, out, n, d, *p, s)
                              : launch_plan<false>(pl, x, out, n, d, *p, s);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}
