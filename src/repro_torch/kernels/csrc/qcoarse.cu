// qcoarse: the compressed tier's int8 coarse scan for Hopper (sm_90a).
//
// out[i, j] = sum_k w[i, k] * c[j, k], int32 weights (|w| <= 2^28), int8
// codes, int64 output. Each weight is split once into its signed top limb
// w3 = w >> 24 and three unsigned 8-bit limbs w2, w1, w0, so that
// w = (w3 << 24) + (w2 << 16) + (w1 << 8) + w0. Four int32 planes
// P_l = sum_k w_l * c accumulate with dp4a (four multiply-adds per
// instruction: dp4a.s32.s32 for the signed top limb, dp4a.u32.s32 for the
// unsigned low limbs); every plane stays exact in int32 for d <= 8192
// (255 * 127 * 8192 < 2^31). The planes combine into int64 at the store,
// so nothing of size [nq, nn, 4] ever reaches memory.
//
// Two kernels, one launch function:
//   1. qcoarse_limbs: w [nq, d] -> limb words [nq, dw, 4] (dw = ceil(d/4)):
//      word l of group g packs limb l of w[., 4g .. 4g+3], one byte each,
//      zero past d;
//   2. qcoarse_kernel: one 64 x 64 output tile per block, the depth walked
//      32 words (128 codes) at a time, each thread owning a 4 x 4 tile of
//      outputs with four int32 plane accumulators each. Codes are read four
//      at a time as 32-bit words where the row stride allows it; ragged
//      nq, nn and d are masked (zero-filled loads, bounded stores).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64, kBN = 64, kBW = 32;  // tile rows, cols, depth words
constexpr int kTQ = 4, kTN = 4;
constexpr int kThreads = (kBQ / kTQ) * (kBN / kTN);  // 256
constexpr int kRowsPerStep = kThreads / kBW;         // 8

__device__ __forceinline__ int dp4a_ss(int a, int b, int c) {
  int d;
  asm("dp4a.s32.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ int dp4a_us(unsigned a, int b, int c) {
  int d;
  asm("dp4a.u32.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__global__ void qcoarse_limbs(const int32_t* __restrict__ w,
                              uint4* __restrict__ limbs, int64_t nq, int64_t d,
                              int64_t dw) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= nq * dw) return;
  const int64_t q = idx / dw, g = idx % dw;
  unsigned l3 = 0, l2 = 0, l1 = 0, l0 = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int64_t k = 4 * g + b;
    const int32_t v = k < d ? w[q * d + k] : 0;
    const int sh = 8 * b;
    l3 |= (static_cast<unsigned>(v >> 24) & 0xFFu) << sh;  // signed byte
    l2 |= ((static_cast<unsigned>(v) >> 16) & 0xFFu) << sh;
    l1 |= ((static_cast<unsigned>(v) >> 8) & 0xFFu) << sh;
    l0 |= (static_cast<unsigned>(v) & 0xFFu) << sh;
  }
  limbs[idx] = make_uint4(l3, l2, l1, l0);
}

template <bool kWordLoads>
__device__ __forceinline__ int load_code_word(const int8_t* __restrict__ c,
                                              int64_t row, int64_t g,
                                              int64_t d) {
  if (kWordLoads) {  // d % 4 == 0 and the base is 4-byte aligned
    return 4 * g < d ? *reinterpret_cast<const int*>(c + row * d + 4 * g) : 0;
  }
  unsigned word = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int64_t k = 4 * g + b;
    const unsigned byte = k < d ? static_cast<uint8_t>(c[row * d + k]) : 0u;
    word |= byte << (8 * b);
  }
  return static_cast<int>(word);
}

template <bool kWordLoads>
__global__ void __launch_bounds__(kThreads)
qcoarse_kernel(const uint4* __restrict__ limbs, const int8_t* __restrict__ c,
               long long* __restrict__ out, int64_t nq, int64_t nn, int64_t d,
               int64_t dw) {
  // limb words [depth word][query row], padded so that the column-wise
  // stores of the load step fall in distinct banks; codes row-major
  // [row][depth word], padded likewise
  __shared__ uint4 ws[kBW][kBQ + 1];
  __shared__ int cs[kBN][kBW + 1];

  const int tid = threadIdx.x;
  const int tq = tid / (kBN / kTN);  // 0..15: rows 4*tq .. 4*tq+3
  const int tn = tid % (kBN / kTN);  // 0..15: cols tn, tn+16, tn+32, tn+48
  const int64_t q0 = static_cast<int64_t>(blockIdx.y) * kBQ;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kBN;
  const int lw = tid % kBW;  // depth word this thread loads
  const int lr = tid / kBW;  // first row this thread loads

  int acc[kTQ][kTN][4];
#pragma unroll
  for (int i = 0; i < kTQ; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j)
#pragma unroll
      for (int l = 0; l < 4; ++l) acc[i][j][l] = 0;

  for (int64_t g0 = 0; g0 < dw; g0 += kBW) {
    const int64_t g = g0 + lw;
#pragma unroll
    for (int r = lr; r < kBQ; r += kRowsPerStep) {
      const int64_t gq = q0 + r;
      ws[lw][r] = (gq < nq && g < dw) ? limbs[gq * dw + g]
                                      : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int r = lr; r < kBN; r += kRowsPerStep) {
      const int64_t gn = n0 + r;
      cs[r][lw] = gn < nn ? load_code_word<kWordLoads>(c, gn, g, d) : 0;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kBW; ++kk) {
      uint4 a[kTQ];
      int b[kTN];
#pragma unroll
      for (int i = 0; i < kTQ; ++i) a[i] = ws[kk][kTQ * tq + i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) b[j] = cs[tn + 16 * j][kk];
#pragma unroll
      for (int i = 0; i < kTQ; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          acc[i][j][0] = dp4a_ss(static_cast<int>(a[i].x), b[j], acc[i][j][0]);
          acc[i][j][1] = dp4a_us(a[i].y, b[j], acc[i][j][1]);
          acc[i][j][2] = dp4a_us(a[i].z, b[j], acc[i][j][2]);
          acc[i][j][3] = dp4a_us(a[i].w, b[j], acc[i][j][3]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTQ; ++i) {
    const int64_t gq = q0 + kTQ * tq + i;
    if (gq >= nq) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int64_t gn = n0 + tn + 16 * j;
      if (gn < nn) {
        const int* p = acc[i][j];
        out[gq * nn + gn] = static_cast<long long>(p[0]) * (1LL << 24) +
                            static_cast<long long>(p[1]) * (1LL << 16) +
                            static_cast<long long>(p[2]) * (1LL << 8) +
                            static_cast<long long>(p[3]);
      }
    }
  }
}

}  // namespace

// w int32 [nq, d], c int8 [nn, d], limbs scratch [nq, ceil(d/4), 4] int32,
// out int64 [nq, nn]. Returns cudaGetLastError() after both launches.
extern "C" int qcoarse_launch(const int32_t* w, const int8_t* c, void* limbs,
                              long long* out, int64_t nq, int64_t nn,
                              int64_t d, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t dw = (d + 3) / 4;
  if (nq > 0 && nn > 0) {
    const int64_t n_words = nq * dw;
    if (n_words > 0) {
      qcoarse_limbs<<<static_cast<unsigned>((n_words + 255) / 256), 256, 0, s>>>(
          w, static_cast<uint4*>(limbs), nq, d, dw);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const dim3 grid(static_cast<unsigned>((nn + kBN - 1) / kBN),
                    static_cast<unsigned>((nq + kBQ - 1) / kBQ));
    const bool words = d % 4 == 0 && reinterpret_cast<uintptr_t>(c) % 4 == 0;
    if (words) {
      qcoarse_kernel<true><<<grid, kThreads, 0, s>>>(
          static_cast<const uint4*>(limbs), c, out, nq, nn, d, dw);
    } else {
      qcoarse_kernel<false><<<grid, kThreads, 0, s>>>(
          static_cast<const uint4*>(limbs), c, out, nq, nn, d, dw);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
