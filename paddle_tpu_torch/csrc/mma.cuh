// Tensor-core building blocks shared by the port's hand-written Hopper
// kernels: the flash attention forward (K1, flash_attention_fwd.cu) and
// backward (K2a / K2b, flash_attention_bwd.cu), and the cp.async staging of
// the paged decode (paged_flash_decode.cuh).
//
// A tensor-core block is 4 warps; each warp owns 16 rows of a 64-row
// resident tile.  16-bit products are mma.sync.m16n8k16 (f32 accumulators)
// fed by ldmatrix out of shared memory, whose tiles are [rows][DP + 8] in
// the input dtype: the 16-byte row pad puts ldmatrix's eight row reads on
// distinct banks (K2a at head_dim 256, and in f32 at 128, and K1's f32
// body at 256 run 8 warps: two per 16-row group, each owning half of
// head_dim).  f32 products are three mma.sync.m16n8k8 TF32 products
// (3xTF32: each operand split into a TF32 "big" part and a TF32 "small"
// remainder, the small x small term dropped), about 2^-21 relative per
// product.  Tiles are filled by 16-byte cp.async.cg copies when a tensor
// allows them (vec_mask), else by a scalar loop.
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

// ---------------------------------------------------------------- 3xTF32
// x = big + small, both read by the mma as TF32: big is x rounded to TF32
// (nearest, ties away from zero: what cvt.rna.tf32.f32 gives a finite x,
// here in two integer ops, where the PTX conversion compiles to a longer
// sequence on sm_90a); small = x - big is exact in f32, and the mma reads
// its top 19 bits (truncation), so big + small carries x to about 2^-21
// relative.
struct Tf32Pair {
  uint32_t big, small;
};

__device__ __forceinline__ Tf32Pair split_tf32(float x) {
  const uint32_t big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  return {big, __float_as_uint(x - __uint_as_float(big))};
}

// c[16x8] += a[16x8] . b[8x8], TF32 inputs, f32 accumulators.  Fragments
// (g = lane / 4, t = lane % 4): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4); b0 (k t, n g), b1 (k t + 4, n g); c as m16n8k16's.
__device__ __forceinline__ void mma1688_tf32(float (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment of four f32 values, split: big[i] + small[i] = x[i]
struct Tf32Frag {
  uint32_t big[4], small[4];
};

__device__ __forceinline__ Tf32Frag split_frag(float x0, float x1, float x2,
                                               float x3) {
  const float x[4] = {x0, x1, x2, x3};
  Tf32Frag f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const Tf32Pair p = split_tf32(x[i]);
    f.big[i] = p.big;
    f.small[i] = p.small;
  }
  return f;
}

// c += a . b in f32 accuracy from three TF32 products: the two cross terms
// first, the big x big term last
__device__ __forceinline__ void mma1688_3xtf32(float (&c)[4],
                                               const Tf32Frag& a, float b0,
                                               float b1) {
  const Tf32Pair p0 = split_tf32(b0);
  const Tf32Pair p1 = split_tf32(b1);
  mma1688_tf32(c, a.small, p0.big, p1.big);
  mma1688_tf32(c, a.big, p0.small, p1.small);
  mma1688_tf32(c, a.big, p0.big, p1.big);
}

// Stage rows [row0, row0 + R) of one (batch, head) slice into an [R][RS]
// tile in T (RS >= DP; DP + 8 for the 16-bit tiles); rows past n and
// columns past D are zero.  `vec`: 16-byte cp.async (whole 16-byte chunks
// per row, base and strides 16-byte aligned), else a scalar loop.  NTH:
// the block's threads, which share the copies.
template <typename T, int R, int DP, int RS = DP + 8, int NTH = kTcThreads>
__device__ __forceinline__ void stage_tc(T* dst, const T* src, long long ss,
                                         int row0, int n, int D, bool vec) {
  if (vec) {
    constexpr int EPC = 16 / sizeof(T); // elements per 16-byte chunk
    constexpr int CH = DP / EPC;        // 16-byte chunks per row
    for (int idx = threadIdx.x; idx < R * CH; idx += NTH) {
      const int rr = idx / CH;
      const int c = idx % CH;
      const int row = row0 + rr;
      const bool ok = row < n && c * EPC < D;
      cp_async16(dst + rr * RS + c * EPC, ok ? src + row * ss + c * EPC : src,
                 ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < R * DP; idx += NTH) {
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
