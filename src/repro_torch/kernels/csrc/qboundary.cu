// qboundary: the fused determinism boundary for Hopper (sm_90a).
//
// float32 [n, d] -> int32 [n, d]: Q-encode (round half away from zero,
// clamp, saturating convert), then for unit_norm the exact integer L2
// normalization: int64 sum of squares (wrapping), 32-step isqrt, and
// (raw << frac_bits) / norm rounded half away from zero; zero-norm rows
// pass through. One block per row.
//
// Every float32 step is a separately rounded intrinsic (__fmul_rn,
// __fadd_rn, floorf), so nothing contracts into an FMA; the library is
// also built with -fmad=false.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int32_t encode_one(float x, float one, float lo,
                                              float hi) {
  const float scaled = __fmul_rn(x, one);
  if (isnan(scaled)) return 0;  // NaN converts to 0
  const float r = floorf(__fadd_rn(fabsf(scaled), 0.5f));
  float s = scaled > 0.f ? r : (scaled < 0.f ? -r : 0.f);  // sign * floor
  s = fminf(fmaxf(s, lo), hi);
  // saturating convert: hi may be float32(2^31 - 1) == 2^31
  if (s >= 2147483648.0f) return INT32_MAX;
  if (s < -2147483648.0f) return INT32_MIN;
  return static_cast<int32_t>(s);
}

__global__ void __launch_bounds__(kThreads)
qboundary_kernel(const float* __restrict__ x, int32_t* __restrict__ out,
                 int64_t d, float one, float lo, float hi, int64_t min_raw,
                 int64_t max_raw, int frac_bits, int unit_norm) {
  const int64_t row = blockIdx.x;
  const float* xr = x + row * d;
  int32_t* orow = out + row * d;

  unsigned long long sq = 0;  // wraps mod 2^64 like the int64 reference
  for (int64_t j = threadIdx.x; j < d; j += kThreads) {
    const int32_t r = encode_one(xr[j], one, lo, hi);
    orow[j] = r;
    const long long w = r;
    sq += static_cast<unsigned long long>(w * w);
  }
  if (!unit_norm) return;

  __shared__ unsigned long long warp_sums[kThreads / 32];
  __shared__ long long norm_sh;
  for (int off = 16; off > 0; off >>= 1)
    sq += __shfl_down_sync(0xffffffffu, sq, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = sq;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long tot = 0;
    for (int w = 0; w < kThreads / 32; ++w) tot += warp_sums[w];
    long long rem = static_cast<long long>(tot), res = 0;
    for (int i = 0; i < 32; ++i) {  // the reference's digit recurrence
      const long long bit = 1LL << (62 - 2 * i);
      if (rem >= res + bit) {
        rem -= res + bit;
        res = (res >> 1) + bit;
      } else {
        res >>= 1;
      }
    }
    norm_sh = res;
  }
  __syncthreads();
  const long long norm = norm_sh;
  if (norm == 0) return;  // zero row: the encoded row is the answer

  for (int64_t j = threadIdx.x; j < d; j += kThreads) {
    const long long num = static_cast<long long>(orow[j]) * (1LL << frac_bits);
    const long long a = num < 0 ? -num : num;
    const long long q = a / norm;
    const long long rem = a - q * norm;
    const long long mag = q + ((2 * rem >= norm) ? 1 : 0);
    long long v = num < 0 ? -mag : mag;
    v = v < min_raw ? min_raw : (v > max_raw ? max_raw : v);
    orow[j] = static_cast<int32_t>(v);
  }
}

}  // namespace

extern "C" int qboundary_launch(const float* x, int32_t* out, int64_t n,
                                int64_t d, float one, float lo, float hi,
                                int64_t min_raw, int64_t max_raw,
                                int frac_bits, int unit_norm, void* stream) {
  if (n > 0 && d > 0) {
    qboundary_kernel<<<static_cast<unsigned>(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        x, out, d, one, lo, hi, min_raw, max_raw, frac_bits, unit_norm);
  }
  return static_cast<int>(cudaGetLastError());
}
