// qcoarse: the compressed tier's int8 coarse scan for Hopper (sm_90a).
//
// out[i, j] = sum_k w[i, k] * c[j, k], int32 weights, int8 codes, int64
// output, on the int8 tensor cores. Each weight is split once into its
// signed top limb w3 = w >> 24 and three unsigned bytes w2, w1, w0, so
// that w = (w3 << 24) + (w2 << 16) + (w1 << 8) + w0. Four s32 planes
// P_l = sum_k w_l * c are int8 x int8 products (s8 x s8 for w3, u8 x s8
// for the others); each is exact for d <= 8192 (255 * 127 * 8192 < 2^31)
// and they combine into int64 only at the store, so nothing of size
// [nq, nn, 4] reaches memory.
//
// Two kernels, one launch function:
//   1. split_rows: w [nq, d] -> byte planes, tiled so that the weights of
//      one (64-row tile, 128-deep stage) are one contiguous 32 KB block in
//      the tensor cores' swizzled layout (imma.cuh), zero past nq and d;
//   2. qcoarse_imma: one block per 64 weight rows x 128 code rows. The
//      codes are the wgmma A operand, straight from device memory and
//      taken from registers (64 code rows a warpgroup, each fragment used
//      by all four limb products; output transposed on the store); the
//      weight planes are the B operand (N = 64) in shared memory. Stages
//      of 128 codes stream through a 4-deep cp.async ring (16 bytes a
//      thread, whole 128-byte lines per eight threads, zero-filled past
//      nn and d), the weight planes beside them.
// Codes whose rows are not 16-byte multiples or whose base is not
// 16-byte aligned take plain byte loads into the same ring
// (`qcoarse_path` says which path a launch takes).
#include <cuda_runtime.h>
#include <stdint.h>

#include "imma.cuh"

namespace {

using namespace imma;

constexpr int kKc = 128;            // depth per stage, in codes
constexpr int kChunks = kKc / 16;   // 16-byte columns per stage
constexpr int kBQ = 64;             // weight rows per block (N = 64)
constexpr int kBN = 128;            // code rows per block: 64 a warpgroup
constexpr int kStages = 4;
constexpr int kThreads = 256;
constexpr int kStride = kKc + 16;            // padded raw code row
constexpr int kPlane = kBQ * kKc;            // one weight limb plane, 8 KB
constexpr int kStageW = 4 * kPlane;          // 32 KB of weight planes
constexpr int kStage = kStageW + kBN * kStride;
constexpr int kSmem = kStages * kStage + 1024;  // + room to align to 1 KB

// Depth order. Thread t % 4 = c reads the 32 contiguous codes
// [32c, 32c + 32) of a stage row in two 16-byte loads and uses them as its
// A fragments of the four 32-deep steps: code 32c + 8s + 4h + e sits at
// position 32s + 16h + 4c + e of step s's wgmma depth. The weight planes
// are written in that same order, so the products pair the same k.
__device__ __forceinline__ int code_of_position(int pos) {
  const int s = pos / 32, h = (pos / 16) % 2, c = (pos / 4) % 4, e = pos % 4;
  return 32 * c + 8 * s + 4 * h + e;
}

// One block per (stage, 64-row tile), one thread per 16 positions.
__global__ void __launch_bounds__(kThreads)
split_rows(const int32_t* __restrict__ w, uint8_t* __restrict__ planes,
           int64_t nq, int64_t d) {
  const int64_t stage = blockIdx.x, tile = blockIdx.y;
  uint8_t* base = planes + (tile * gridDim.x + stage) * kStageW;
  for (int item = threadIdx.x; item < kBQ * kChunks; item += blockDim.x) {
    const int row = item % kBQ, chunk = item / kBQ;
    const int64_t gq = tile * kBQ + row;
    int32_t v[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int64_t k = stage * kKc + code_of_position(16 * chunk + e);
      v[e] = (gq < nq && k < d) ? w[gq * d + k] : 0;
    }
    split16(v, base + swz<kKc>(row, chunk), kPlane);
  }
}

template <bool kAsync>
__global__ void __launch_bounds__(kThreads, 1)
qcoarse_imma(const uint8_t* __restrict__ planes, const int8_t* __restrict__ c,
             long long* __restrict__ out, int64_t nq, int64_t nn, int64_t d) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_1k(smem_raw);
  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128;
  const int64_t tile = blockIdx.y;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kBN;
  const int nst = static_cast<int>((d + kKc - 1) / kKc);
  const uint8_t* w_src = planes + tile * nst * kStageW;
  // this thread's fragment rows and depth bytes within a stage
  const int frow = wg * 64 + 16 * (t / 32) + (t % 32) / 4;
  const int fbyte = 32 * (t % 4);

  int acc[4][32];  // planes of w3, w2, w1, w0
#pragma unroll
  for (int l = 0; l < 4; ++l)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[l][i] = 0;

  auto load = [&](int st) {
    if (st < nst) {
      uint8_t* sw = smem + (st % kStages) * kStage;
      uint8_t* sc = sw + kStageW;
      const uint8_t* gw = w_src + int64_t(st) * kStageW;
#pragma unroll
      for (int u = tid; u < kStageW / 16; u += kThreads)
        cp_async16(sw + 16 * u, gw + 16 * u, 16);
      // eight neighbouring threads read one row's 128 codes: whole lines
#pragma unroll
      for (int u = tid; u < kBN * kChunks; u += kThreads) {
        const int row = u / kChunks, chunk = u % kChunks;
        const int64_t g = n0 + row, k = int64_t(st) * kKc + chunk * 16;
        uint8_t* s = sc + row * kStride + chunk * 16;
        if constexpr (kAsync) {
          const bool in = g < nn && k < d;
          cp_async16(s, in ? c + g * d + k : c, in ? 16 : 0);
        } else {
#pragma unroll
          for (int e = 0; e < 16; ++e)
            s[e] = (g < nn && k + e < d) ? static_cast<uint8_t>(c[g * d + k + e])
                                         : uint8_t(0);
        }
      }
    }
    cp_async_commit();  // empty groups keep the count uniform
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) load(s);

  for (int st = 0; st < nst; ++st) {
    cp_async_wait<kStages - 2>();
    fence_proxy_async();
    __syncthreads();  // stage st landed; every product of stage st - 1 done
    uint8_t* sw = smem + (st % kStages) * kStage;
    const uint8_t* sc = sw + kStageW + frow * kStride + fbyte;
    // A fragments of the four steps: a[s] = {row r, r + 8} x {h = 0, 1}
    uint32_t a[4][4];
#pragma unroll
    for (int r8 = 0; r8 < 2; ++r8)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const uint4 x = *reinterpret_cast<const uint4*>(
            sc + 8 * r8 * kStride + 16 * half);
        const uint32_t w4[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {  // bytes 16 half + 4 i = 8 s + 4 h
          const int s = 2 * half + i / 2, h = i % 2;
          a[s][r8 + 2 * h] = w4[i];
        }
      }
    const uint32_t b0 = smem_u32(sw);
    wg_fence();
#pragma unroll
    for (int l = 0; l < 4; ++l) fence_regs(acc[l]);
#pragma unroll
    for (int s = 0; s < kKc / 32; ++s) {
      mma_n64_rs<true, true>(acc[0], a[s], desc<kKc>(b0 + 32 * s));
      mma_n64_rs<true, false>(acc[1], a[s], desc<kKc>(b0 + kPlane + 32 * s));
      mma_n64_rs<true, false>(acc[2], a[s],
                              desc<kKc>(b0 + 2 * kPlane + 32 * s));
      mma_n64_rs<true, false>(acc[3], a[s],
                              desc<kKc>(b0 + 3 * kPlane + 32 * s));
    }
    wg_commit();
    load(st + kStages - 1);  // into the slot of stage st - 1
    wg_wait<0>();
#pragma unroll
    for (int l = 0; l < 4; ++l) fence_regs(acc[l]);
#pragma unroll
    for (int s = 0; s < 4; ++s) fence_regs(a[s]);  // live until here
  }

  // D is [code row, weight row]: register i of thread t holds code row
  // frag_row(t, i) of this warpgroup's 64 and weight row frag_col(t, i)
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int64_t gn = n0 + wg * 64 + frag_row(t, i);
    const int64_t gq = tile * kBQ + frag_col(t, i);
    if (gq < nq && gn < nn)
      out[gq * nn + gn] = static_cast<long long>(acc[0][i]) * (1LL << 24) +
                          static_cast<long long>(acc[1][i]) * (1LL << 16) +
                          static_cast<long long>(acc[2][i]) * (1LL << 8) +
                          static_cast<long long>(acc[3][i]);
  }
}

template <bool kAsync>
cudaError_t launch_imma(const uint8_t* planes, const int8_t* c,
                        long long* out, int64_t nq, int64_t nn, int64_t d,
                        cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      qcoarse_imma<kAsync>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(static_cast<unsigned>((nn + kBN - 1) / kBN),
                  static_cast<unsigned>((nq + kBQ - 1) / kBQ));
  qcoarse_imma<kAsync><<<grid, kThreads, kSmem, s>>>(planes, c, out, nq, nn, d);
  return cudaGetLastError();
}

}  // namespace

// Bytes of the weight-plane scratch a launch needs.
extern "C" int64_t qcoarse_scratch_bytes(int64_t nq, int64_t d) {
  return ((nq + kBQ - 1) / kBQ) * ((d + kKc - 1) / kKc) * kStageW;
}

// The path a launch takes: 1 = cp.async code loads, 0 = plain loads.
extern "C" int qcoarse_path(const void* c, int64_t d) {
  return d % 16 == 0 && reinterpret_cast<uintptr_t>(c) % 16 == 0;
}

// w int32 [nq, d], c int8 [nn, d], planes scratch of
// qcoarse_scratch_bytes(nq, d) bytes, out int64 [nq, nn]. Returns
// cudaGetLastError() after both launches.
extern "C" int qcoarse_launch(const int32_t* w, const int8_t* c, void* planes,
                              long long* out, int64_t nq, int64_t nn,
                              int64_t d, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nq <= 0 || nn <= 0) return static_cast<int>(cudaGetLastError());
  const int64_t nst = (d + kKc - 1) / kKc;
  uint8_t* p = static_cast<uint8_t*>(planes);
  if (nst > 0) {
    split_rows<<<dim3(static_cast<unsigned>(nst),
                      static_cast<unsigned>((nq + kBQ - 1) / kBQ)),
                 kThreads, 0, s>>>(w, p, nq, d);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cudaError_t err = qcoarse_path(c, d)
                              ? launch_imma<true>(p, c, out, nq, nn, d, s)
                              : launch_imma<false>(p, c, out, nq, nn, d, s);
  return static_cast<int>(err);
}
