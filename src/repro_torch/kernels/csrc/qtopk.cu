// qtopk: deterministic k-smallest (int64 score, int32 key) per row block,
// for Hopper (sm_90a).
//
// One block per (column block, query row). The block's bn <= 1024 lanes
// sit in registers, up to four per thread. kk passes each take the
// lexicographic minimum (score, key) over the block, write it out, and
// retire the lanes that carry it (their score becomes INT64_MAX, their
// key stays) — the selection rule of the reference kernel, pad lanes
// (INT64_MAX, INT32_MAX) included, so the candidate lists match it
// entry for entry. The wrapper merges the n_blocks * kk candidates.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLanes = 4;  // kThreads * kMaxLanes = 1024 = largest bn

__device__ __forceinline__ bool lex_less(long long s_a, int k_a, long long s_b,
                                         int k_b) {
  return s_a < s_b || (s_a == s_b && k_a < k_b);
}

__global__ void __launch_bounds__(kThreads)
qtopk_kernel(const long long* __restrict__ scores,
             const int32_t* __restrict__ keys, long long* __restrict__ cand_s,
             int32_t* __restrict__ cand_k, int64_t n, int bn, int kk,
             int n_blocks) {
  const int blk = blockIdx.x;
  const int64_t row = blockIdx.y;
  long long s[kMaxLanes];
  int key[kMaxLanes];
  bool live[kMaxLanes];
#pragma unroll
  for (int l = 0; l < kMaxLanes; ++l) {
    const int lane = threadIdx.x + l * kThreads;
    const int64_t col = static_cast<int64_t>(blk) * bn + lane;
    live[l] = lane < bn;
    if (live[l] && col < n) {
      s[l] = scores[row * n + col];
      key[l] = keys[col];
    } else {  // pad lane of the last block
      s[l] = INT64_MAX;
      key[l] = INT32_MAX;
    }
  }

  __shared__ long long ws[kThreads / 32];
  __shared__ int wk[kThreads / 32];
  __shared__ long long best_s;
  __shared__ int best_k;
  const int warp = threadIdx.x >> 5, lane32 = threadIdx.x & 31;
  const int64_t out_base = row * static_cast<int64_t>(n_blocks) * kk +
                           static_cast<int64_t>(blk) * kk;

  for (int t = 0; t < kk; ++t) {
    long long ms = INT64_MAX;
    int mk = INT32_MAX;
#pragma unroll
    for (int l = 0; l < kMaxLanes; ++l)
      if (live[l] && lex_less(s[l], key[l], ms, mk)) {
        ms = s[l];
        mk = key[l];
      }
    for (int off = 16; off > 0; off >>= 1) {
      const long long os = __shfl_down_sync(0xffffffffu, ms, off);
      const int ok = __shfl_down_sync(0xffffffffu, mk, off);
      if (lex_less(os, ok, ms, mk)) {
        ms = os;
        mk = ok;
      }
    }
    if (lane32 == 0) {
      ws[warp] = ms;
      wk[warp] = mk;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < kThreads / 32; ++w)
        if (lex_less(ws[w], wk[w], ms, mk)) {
          ms = ws[w];
          mk = wk[w];
        }
      best_s = ms;
      best_k = mk;
      cand_s[out_base + t] = ms;
      cand_k[out_base + t] = mk;
    }
    __syncthreads();
    ms = best_s;
    mk = best_k;
    // retire: a lane is chosen when (on the minimum score ? key : INT32_MAX)
    // equals the minimum key — the reference's rule, ties and pads included
#pragma unroll
    for (int l = 0; l < kMaxLanes; ++l) {
      const int km = (s[l] == ms) ? key[l] : INT32_MAX;
      if (live[l] && km == mk) s[l] = INT64_MAX;
    }
  }
}

}  // namespace

extern "C" int qtopk_launch(const long long* scores, const int32_t* keys,
                            long long* cand_s, int32_t* cand_k, int64_t nq,
                            int64_t n, int bn, int kk, void* stream) {
  if (nq > 0 && n > 0 && kk > 0) {
    const int n_blocks = static_cast<int>((n + bn - 1) / bn);
    const dim3 grid(static_cast<unsigned>(n_blocks), static_cast<unsigned>(nq));
    qtopk_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        scores, keys, cand_s, cand_k, n, bn, kk, n_blocks);
  }
  return static_cast<int>(cudaGetLastError());
}
