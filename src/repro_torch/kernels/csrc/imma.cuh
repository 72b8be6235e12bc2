// imma.cuh: the pieces qgemm.cu and qcoarse.cu share to run exact integer
// products on Hopper's int8 tensor cores (sm_90a).
//
// Shared-memory layout. Every tensor-core operand tile is K-major with the
// hardware's swizzle: a tile of rows of RB = 64 or 128 bytes of depth is
// stored row after row, and the 16-byte column c of row r sits at column
// c ^ swz(r) (swz(r) = r % 8 for RB = 128, (r / 2) % 4 for RB = 64), so
// that the eight rows a tensor-core read touches fall in distinct banks.
// A wgmma descriptor names the start of the 64-row (A) or N-row (B)
// slice plus the byte offset of its 32-byte depth step, SBO = 8 * RB (the
// next 8 rows) and the swizzle mode; the tile base is 8 * RB aligned.
//
// Limbs. A value is cut into four 8-bit limbs, byte 3 (signed) down to
// byte 0 (unsigned): v = b3 * 2^24 + b2 * 2^16 + b1 * 2^8 + b0 for every
// int32. Rows are split into four byte planes in that same tile layout
// (`split16`), plane 0 holding byte 3.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace imma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; `bytes` < 16 zero-fills
// the rest (0 reads nothing).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// shared-memory writes of the generic proxy (st.shared, cp.async) become
// visible to the tensor cores' async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of 16-byte column `chunk` of row `row` in a swizzled tile
// of kRowBytes-byte rows.
template <int kRowBytes>
__device__ __forceinline__ int swz(int row, int chunk) {
  static_assert(kRowBytes == 64 || kRowBytes == 128, "64 or 128-byte rows");
  const int s = kRowBytes == 128 ? row % 8 : (row / 2) % 4;
  return row * kRowBytes + ((chunk ^ s) << 4);
}

// wgmma descriptor of a K-major swizzled tile slice starting at `addr`
// (the slice's first row, plus the byte offset of its depth step).
template <int kRowBytes>
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  constexpr uint64_t kMode = kRowBytes == 128 ? 1 : 2;  // 128B / 64B swizzle
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (uint64_t(1) << 16) |                            // LBO (unused)
         (static_cast<uint64_t>((8 * kRowBytes) >> 4) << 32) |
         (kMode << 62);
}

// The dynamic shared memory, rounded up to 1024 bytes (launch with
// 1024 bytes to spare).
__device__ __forceinline__ uint8_t* smem_1k(uint8_t* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + ((1024 - (a & 1023)) & 1023);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accumulator reads or writes across the
// asynchronous products
template <typename T, int N>
__device__ __forceinline__ void fence_regs(T (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define IMMA_R16 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define IMMA_O16(d)                                                         \
  "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),   \
      "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]),          \
      "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
#define IMMA_N32(AT, BT)                                                    \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n32k32.s32." AT "." BT " " IMMA_R16 \
      ", %16, %17, p;\n}\n"                                                 \
      : IMMA_O16(d)                                                         \
      : "l"(a), "l"(b), "r"(1))

// d[16] += A[64 x 32] * B[32 x 32]^T, s32 accumulation (one warpgroup);
// kSa / kSb: the operand's bytes are signed (s8) or unsigned (u8)
template <bool kSa, bool kSb>
__device__ __forceinline__ void mma_n32(int (&d)[16], uint64_t a, uint64_t b) {
  if constexpr (kSa && kSb) IMMA_N32("s8", "s8");
  else if constexpr (kSa) IMMA_N32("s8", "u8");
  else if constexpr (kSb) IMMA_N32("u8", "s8");
  else IMMA_N32("u8", "u8");
}

#define IMMA_R32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31}"
#define IMMA_O32(d)                                                         \
  "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),   \
      "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]),          \
      "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),      \
      "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),      \
      "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),      \
      "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),      \
      "+r"(d[31])
#define IMMA_N64(AT, BT)                                                    \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n64k32.s32." AT "." BT " " IMMA_R32 \
      ", %32, %33, p;\n}\n"                                                 \
      : IMMA_O32(d)                                                         \
      : "l"(a), "l"(b), "r"(1))

// d[32] += A[64 x 32] * B[64 x 32]^T, s32 accumulation (one warpgroup)
template <bool kSa, bool kSb>
__device__ __forceinline__ void mma_n64(int (&d)[32], uint64_t a, uint64_t b) {
  if constexpr (kSa && kSb) IMMA_N64("s8", "s8");
  else if constexpr (kSa) IMMA_N64("s8", "u8");
  else if constexpr (kSb) IMMA_N64("u8", "s8");
  else IMMA_N64("u8", "u8");
}

#define IMMA_N64_RS(AT, BT)                                                 \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n64k32.s32." AT "." BT " " IMMA_R32 \
      ", {%32, %33, %34, %35}, %36, p;\n}\n"                                \
      : IMMA_O32(d)                                                         \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))

// d[32] += A[64 x 32] * B[64 x 32]^T with A from registers: register j of
// thread t holds the four consecutive depth bytes 4 * (t % 4) + 16 * (j / 2)
// .. + 3 of row 16 * (t / 32) + (t % 32) / 4 + 8 * (j % 2)
template <bool kSa, bool kSb>
__device__ __forceinline__ void mma_n64_rs(int (&d)[32], const uint32_t (&a)[4],
                                           uint64_t b) {
  if constexpr (kSa && kSb) IMMA_N64_RS("s8", "s8");
  else if constexpr (kSa) IMMA_N64_RS("s8", "u8");
  else if constexpr (kSb) IMMA_N64_RS("u8", "s8");
  else IMMA_N64_RS("u8", "u8");
}

// whether `v` holds in any thread of warpgroup `wg` (named barrier 1 + wg)
__device__ __forceinline__ bool wg_any(bool v, int wg) {
  int r;
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.u32 p, %1, 0;\n"
      "bar.red.or.pred q, %2, 128, p;\nselp.u32 %0, 1, 0, q;\n}\n"
      : "=r"(r)
      : "r"(static_cast<int>(v)), "r"(1 + wg)
      : "memory");
  return r != 0;
}

// The accumulator fragment of m64nNk32 (s32): register i of thread t of
// the warpgroup holds row 16 * (t / 32) + (t % 32) / 4 + 8 * ((i / 2) % 2)
// and column 8 * (i / 4) + 2 * (t % 4) + i % 2.
__device__ __forceinline__ int frag_row(int t, int i) {
  return 16 * (t / 32) + (t % 32) / 4 + 8 * ((i / 2) % 2);
}
__device__ __forceinline__ int frag_col(int t, int i) {
  return 8 * (i / 4) + 2 * (t % 4) + i % 2;
}

// The four bytes k of x0..x3, packed: b[k] = x0.k | x1.k << 8 | ..
__device__ __forceinline__ void transpose4(uint32_t x0, uint32_t x1,
                                           uint32_t x2, uint32_t x3,
                                           uint32_t (&b)[4]) {
  const uint32_t lo01 = __byte_perm(x0, x1, 0x5140);
  const uint32_t hi01 = __byte_perm(x0, x1, 0x7362);
  const uint32_t lo23 = __byte_perm(x2, x3, 0x5140);
  const uint32_t hi23 = __byte_perm(x2, x3, 0x7362);
  b[0] = __byte_perm(lo01, lo23, 0x5410);
  b[1] = __byte_perm(lo01, lo23, 0x7632);
  b[2] = __byte_perm(hi01, hi23, 0x5410);
  b[3] = __byte_perm(hi01, hi23, 0x7632);
}

// Split 16 consecutive values of one row into their byte planes kFirst..3
// (plane p holds byte 3 - p), written at `dst + (p - kFirst) *
// plane_stride`, 16 bytes each. Returns whether any value lies outside
// [-2^23, 2^23).
template <int kFirst = 0, typename T>
__device__ __forceinline__ bool split16(const T (&v)[16], uint8_t* dst,
                                        int plane_stride) {
  uint32_t w[4][4];
  uint32_t mag = 0;  // |x| - (x < 0), or-ed: below 2^23 iff all in range
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t x[4], b[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int32_t s = static_cast<int32_t>(v[4 * j + e]);
      x[e] = static_cast<uint32_t>(s);
      mag |= static_cast<uint32_t>(s ^ (s >> 31));
    }
    transpose4(x[0], x[1], x[2], x[3], b);
#pragma unroll
    for (int p = 0; p < 4; ++p) w[p][j] = b[3 - p];
  }
#pragma unroll
  for (int p = kFirst; p < 4; ++p)
    *reinterpret_cast<uint4*>(dst + (p - kFirst) * plane_stride) =
        make_uint4(w[p][0], w[p][1], w[p][2], w[p][3]);
  return mag >= (1u << 23);
}

}  // namespace imma
