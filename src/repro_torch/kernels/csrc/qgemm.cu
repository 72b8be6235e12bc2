// qgemm: exact wide integer scoring matmul for Hopper (sm_90a).
//
// out[i, j] = sum_k q[i, k] * db[j, k], int32 inputs, int64 output,
// accumulated in int64 on the CUDA cores (32x32 -> 64-bit multiply-add).
// A shared-memory tiled kernel: one 64x64 output tile per block, the
// depth walked in steps of 32, each thread owning a 4x4 register tile.
// Ragged nq, nn and d are masked in the kernel (zero-filled loads,
// bounded stores).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64, kBN = 64, kBK = 32;
constexpr int kTQ = 4, kTN = 4;
constexpr int kThreads = (kBQ / kTQ) * (kBN / kTN);  // 256
constexpr int kRowsPerStep = kThreads / kBK;         // tile rows per load step

__global__ void __launch_bounds__(kThreads)
qgemm_kernel(const int32_t* __restrict__ q, const int32_t* __restrict__ db,
             long long* __restrict__ out, int64_t nq, int64_t nn, int64_t d) {
  __shared__ int32_t qs[kBK][kBQ + 1];  // [k][row], padded against conflicts
  __shared__ int32_t ds[kBK][kBN + 1];

  const int tid = threadIdx.x;
  const int tq = tid / (kBN / kTN);  // 0..15: rows tq, tq+16, tq+32, tq+48
  const int tn = tid % (kBN / kTN);  // 0..15: cols tn, tn+16, ...
  const int64_t q0 = static_cast<int64_t>(blockIdx.y) * kBQ;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kBN;
  const int lc = tid % kBK;  // load column within the depth step
  const int lr = tid / kBK;  // first load row

  long long acc[kTQ][kTN];
#pragma unroll
  for (int i = 0; i < kTQ; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0;

  for (int64_t k0 = 0; k0 < d; k0 += kBK) {
    const int64_t gk = k0 + lc;
#pragma unroll
    for (int r = lr; r < kBQ; r += kRowsPerStep) {
      const int64_t gq = q0 + r;
      qs[lc][r] = (gq < nq && gk < d) ? q[gq * d + gk] : 0;
    }
#pragma unroll
    for (int r = lr; r < kBN; r += kRowsPerStep) {
      const int64_t gn = n0 + r;
      ds[lc][r] = (gn < nn && gk < d) ? db[gn * d + gk] : 0;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      int a[kTQ], b[kTN];
#pragma unroll
      for (int i = 0; i < kTQ; ++i) a[i] = qs[kk][tq + 16 * i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) b[j] = ds[kk][tn + 16 * j];
#pragma unroll
      for (int i = 0; i < kTQ; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j)
          acc[i][j] += static_cast<long long>(a[i]) * b[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTQ; ++i) {
    const int64_t gq = q0 + tq + 16 * i;
    if (gq >= nq) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int64_t gn = n0 + tn + 16 * j;
      if (gn < nn) out[gq * nn + gn] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int qgemm_launch(const int32_t* q, const int32_t* db, long long* out,
                            int64_t nq, int64_t nn, int64_t d, void* stream) {
  if (nq > 0 && nn > 0) {
    const dim3 grid(static_cast<unsigned>((nn + kBN - 1) / kBN),
                    static_cast<unsigned>((nq + kBQ - 1) / kBQ));
    qgemm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        q, db, out, nq, nn, d);
  }
  return static_cast<int>(cudaGetLastError());
}
