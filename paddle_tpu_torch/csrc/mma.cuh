// Tensor-core building blocks shared by the port's hand-written Hopper
// kernels: the bf16 / f16 flash attention forward (K1,
// flash_attention_fwd.cu) and backward (K2a / K2b, flash_attention_bwd.cu),
// and the cp.async staging of the paged decode (paged_flash_decode.cuh).
//
// A tensor-core block is 4 warps; each warp owns 16 rows of a 64-row
// resident tile.  Products are mma.sync.m16n8k16 (16-bit inputs, f32
// accumulators) fed by ldmatrix out of shared memory, whose tiles are
// [rows][DP + 8] in the input dtype: the 16-byte row pad puts ldmatrix's
// eight row reads on distinct banks.  Tiles are filled by 16-byte
// cp.async.cg copies when a tensor allows them (vec_mask), else by a
// scalar loop.
#pragma once

#include "common.cuh"

#include <stdint.h>
#include <string.h>
#include <type_traits>

namespace ptt {
namespace tc {

constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcM = 16 * kTcWarps;     // resident rows per block (64)
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy global -> shared; src_bytes 0 writes zeros (ragged rows,
// padded columns) without reading src
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 16-bit matrices; lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c[16x8] += a[16x16] . b[16x8], 16-bit inputs, f32 accumulators
template <typename T>
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// two f32 rounded to T, the lower column in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  uint32_t u;
  if constexpr (std::is_same<T, __half>::value) {
    const __half2 v = __floats2half2_rn(lo, hi);
    memcpy(&u, &v, 4);
  } else {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    memcpy(&u, &v, 4);
  }
  return u;
}

// The A operand of the next product from two adjacent accumulator tiles
// (columns 16 kq .. 16 kq + 15 of a 16-row score tile), rounded to T.
template <typename T>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack2<T>(lo[0], lo[1]);
  a[1] = pack2<T>(lo[2], lo[3]);
  a[2] = pack2<T>(hi[0], hi[1]);
  a[3] = pack2<T>(hi[2], hi[3]);
}

// Stage rows [row0, row0 + R) of one (batch, head) slice into an
// [R][DP + 8] tile in T; rows past n and columns past D are zero.  `vec`:
// 16-byte cp.async (D % 8 == 0, base and strides 16-byte aligned), else a
// scalar loop.
template <typename T, int R, int DP>
__device__ __forceinline__ void stage_tc(T* dst, const T* src, long long ss,
                                         int row0, int n, int D, bool vec) {
  constexpr int RS = DP + 8;
  if (vec) {
    constexpr int CH = DP / 8;          // 16-byte chunks per row
    for (int idx = threadIdx.x; idx < R * CH; idx += kTcThreads) {
      const int rr = idx / CH;
      const int c = idx % CH;
      const int row = row0 + rr;
      const bool ok = row < n && c * 8 < D;
      cp_async16(dst + rr * RS + c * 8, ok ? src + row * ss + c * 8 : src, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < R * DP; idx += kTcThreads) {
      const int rr = idx / DP;
      const int d = idx % DP;
      const int row = row0 + rr;
      dst[rr * RS + d] =
          (row < n && d < D) ? src[row * ss + d] : ptt::from_f32<T>(0.f);
    }
  }
}

// Bit i set when tensor i of x (n of them, with element strides (batch,
// seq, head) at st[3 i .. 3 i + 2]) can be staged by 16-byte copies:
// whole 16-byte chunks per row, a 16-byte aligned base and strides.
inline int vec_mask(const void* const* x, int n, const long long* st, int D,
                    int elem) {
  int mask = 0;
  for (int i = 0; i < n; ++i) {
    bool ok = (D * elem) % 16 == 0 &&
              reinterpret_cast<uintptr_t>(x[i]) % 16 == 0;
    for (int j = 0; j < 3; ++j) ok = ok && (st[3 * i + j] * elem) % 16 == 0;
    if (ok) mask |= 1 << i;
  }
  return mask;
}

}  // namespace tc
}  // namespace ptt
