// K1: flash attention forward, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/flash_attention.py
// (_flash_fwd -> _fa_kernel, pallas_call at :112).  Same function: blocked
// attention with the online softmax (running max m, denominator l,
// accumulator acc) kept in f32, the causal mask aligned bottom-right (key
// j is visible to query i when j <= i + (Sk - Sq)), key tiles wholly above
// the diagonal skipped, o written in the input dtype as contiguous
// [B, Sq, H, D] and the per-row natural-log logsumexp written in f32 as
// [B * H, Sq] (K2 reads it).
//
// What bounds it on this card: at the prefill and training shapes of the
// served model (S up to 1024, D = 64) the work is about 4 * S^2 * D / 2
// operations per (batch, head) against 4 * S * D * 2 bytes, far above the
// H100's ~295 operations per byte, so a good kernel is bound by
// operations, at the 989 TFLOP/s bf16 / f16 tensor-core rate (f32: three
// TF32 products per product, at 495 TFLOP/s).
//
// Every dtype and head_dim 1-256 runs on the tensor cores, head_dim
// zero-padded to DP = 64, 128 or 256.  No model of the repository runs
// head_dim 129-256 (GPT-base has D = 64, Llama D = 128);
// F.flash_attention, F.scaled_dot_product_attention and an unmasked
// encoder with wider heads reach it.
//
// bf16 / f16 design, after FlashAttention-2's forward and built from K2b's
// parts (mma.cuh): one block of 4 warps per (64-query tile, batch * head);
// each warp owns 16 query rows.  Q is staged once in shared memory in the
// input dtype; 64-key tiles of K and V stream through a double-buffered
// ring by 16-byte cp.async.cg (the next tile loads while the current one
// is computed) up to the causal bound.  S = Q.K^T is mma.sync.m16n8k16 fed
// by ldmatrix; the running max, the rescale and the row sum work on the
// accumulator fragment in registers (base-2 exponent, reduced over the
// four lanes of a row by two shuffles); P is rounded to the input dtype in
// registers and is the A operand of O += P.V, with V read by
// ldmatrix.trans: no score goes through shared memory.  Rows are padded by
// 16 bytes so ldmatrix hits distinct banks.  The element mask runs only on
// tiles that the diagonal or the ragged key edge crosses.  The last query
// tile, which sees the most keys, goes out first, with batch * head as the
// fast grid axis.  Tensors that cannot take 16-byte copies (D * 2 not a
// multiple of 16, a misaligned base or stride) are staged by a scalar loop
// in the same kernel, chosen per tensor by vec_mask.  At DP <= 128 a warp
// holds its Q rows as A fragments in registers, loaded once; at DP = 256
// they would be 64 registers beside O's 128 accumulators (16 rows x 256
// columns), so each 16-deep slice of Q is read by ldmatrix from the
// resident tile inside the key loop, as K2b does.
//
// f32 design (Llama's f32 prefill, every f32 card-vs-CPU gate of the GPT
// phases): the same structure on the tensor cores by 3xTF32.  Each f32
// operand is split into a TF32 big part and a TF32 small remainder
// (mma.cuh split_tf32: big rounded to nearest by two integer ops --
// cvt.rna.tf32.f32 compiles to a longer integer, compare and select
// sequence on sm_90a, which set the pace of this body's first version;
// small = x - big, whose top 19 bits the mma reads) and every product is
// a_small.b_big + a_big.b_small + a_big.b_big, three mma.sync.m16n8k8 TF32
// products accumulated in f32: about 2^-21 relative per product, at up to
// 495 / 3 = 165 TFLOP/s against the 67 TFLOP/s SIMT rate.  Its bound is 3
// x the operations at the TF32 rate.  Each warp owns 16 query rows; Q is
// staged once in shared memory, and K and V tiles stream through a
// double-buffered ring by 16-byte cp.async.cg into f32 rows padded against
// bank conflicts (Q and K rows DP + 8 for the float2 fragment reads, V
// rows DP + 4 for the two-row reads).  TF32 fragments are 32-bit, so there
// is no ldmatrix: fragments come from plain shared loads, and both
// reductions take their k dimension in the order (0, 2, 4, 6, 1, 3, 5, 7)
// within each 8-wide step, which the sums do not depend on.  Then fragment
// columns t and t+4 are adjacent head dims (one float2 of Q and of K per
// lane), and for P.V they are the keys 2t and 2t+1 that the S accumulator
// already holds in the lane: P is the A operand as it stands, with no
// shuffle, and stays f32.  The online softmax, the causal mask and the
// heaviest-tile-first order are the 16-bit body's.  At DP = 256, O of 16
// rows x 256 columns is 128 f32 accumulators a thread, and on 4 warps
// ptxas spilled at 255 registers (20 / 60 bytes at 16 / 32 keys a tile).
// So there the body splits head_dim as K2a does: 8 warps, two per
// 16-query group (warps w and w + 4), each owning 128 columns of O; each
// sums S over its half of head_dim and adds its partner's partial through
// shared memory (one more __syncthreads a tile); a + b == b + a, so both
// hold the same S, and so the same m, l and P.
//
// Tiles (registers and spills as chip_smoke.py's build line lists them;
// H100 80GB HBM3 at 700 W, nvcc 12.8):
//              keys a tile  warps  registers  shared memory  blocks an SM
//   16-bit 64       64        4       138         45.0 KB         3
//   16-bit 128      64        4       237         85.0 KB         2
//   16-bit 256      64        4       250        165.0 KB         1
//   f32 64          64        4       156         88.0 KB         2
//   f32 128         32        4       168        101.0 KB         2
//   f32 256         32        8       210        213.0 KB         1
// The DP = 256 tiles were chosen by measurement: builds of edited copies
// of this file timed in turns with the committed one at [2, 1024, 8, 256]
// causal by graph replay, same card.  bf16 with 32-key tiles (99 KB, two
// blocks an SM, 252 registers) ran 0.0813-0.0814 ms against 0.0631-0.0635
// for 64.  f32: 16-key tiles 0.3062-0.3088 ms against 0.2006-0.2009 for
// 32; 4 warps without the split 0.2323-0.2355 (and its spill); the split's
// k-steps of Q.K^T unrolled whole (16) 0.2829-0.2848, by 4 0.2437-0.2441,
// by 8 (the build) 0.2006-0.2009.
//
// q/k/v are read in the public [B, S, H, D] layout straight from their
// strides (the head dim must be unit-stride), so the qkv split of the
// model needs no copy; the ragged last query and key tiles are masked
// here, where the TPU path padded.
#include "common.cuh"
#include "mma.cuh"

#include <math.h>
#include <type_traits>

namespace {

using namespace ptt::tc;

// ---------------------------------------------- bf16 / f16: tensor cores
constexpr int kNK = 64;                 // keys per streamed tile

template <int DP>
constexpr size_t tc_smem_bytes(size_t elem) {
  // Q [64][DP+8], K and V [2][kNK][DP+8]
  return elem * (kTcM + 4 * kNK) * (DP + 8);
}

// vec: bit i set when tensor i of (q, k, v) takes 16-byte copies.
template <typename T, int DP>
__global__ void __launch_bounds__(kTcThreads)
flash_fwd_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o,
                    float* __restrict__ lse, int H, int Sq, int Sk, int D,
                    long long qsb, long long qss, long long qsh,
                    long long ksb, long long kss, long long ksh,
                    long long vsb, long long vss, long long vsh,
                    float scale, int causal, int vec) {
  constexpr int RS = DP + 8;
  // a warp holds its Q rows as A fragments (DP / 4 registers) at DP <=
  // 128; at DP = 256 it reads each 16-deep slice by ldmatrix in the key loop
  constexpr bool QREG = DP <= 128;
  constexpr int NT = kNK / 8;           // 8-key column tiles of S
  constexpr int DT = DP / 8;            // 8-wide column tiles of o
  constexpr int KQ = DP / 16;           // 16-deep slices of head_dim
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + kTcM * RS;               // [2][kNK][RS]
  T* Vs = Ks + 2 * kNK * RS;            // [2][kNK][RS]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gr = lane / 4;              // accumulator row in the warp's 16
  const int gc = 2 * (lane % 4);        // accumulator column in an 8-tile
  const int lm = lane / 8;              // ldmatrix: which 8x8 matrix
  const int lr = lane % 8;              // ldmatrix: which row of it
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  // the last query tile sees the most keys: it goes out first
  const int q0 =
      ((Sq + kTcM - 1) / kTcM - 1 - static_cast<int>(blockIdx.y)) * kTcM;
  const int offset = Sk - Sq;

  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + h * ksh;
  const T* vb = v + b * vsb + h * vsh;

  // causal: the tile's last valid query sees keys up to q_last + offset
  const int kend = causal ? min(Sk, min(q0 + kTcM, Sq) + offset) : Sk;
  const int ntiles = (kend + kNK - 1) / kNK;

  auto load_tile = [&](int it) {
    const int buf = it & 1;
    stage_tc<T, kNK, DP>(Ks + buf * kNK * RS, kb, kss, it * kNK, Sk, D, vec & 2);
    stage_tc<T, kNK, DP>(Vs + buf * kNK * RS, vb, vss, it * kNK, Sk, D, vec & 4);
  };
  stage_tc<T, kTcM, DP>(Qs, qb, qss, q0, Sq, D, vec & 1);
  load_tile(0);
  cp_async_commit();

  // this lane's two query rows, and the first row of the warp's 16
  const int qi0 = q0 + warp * 16 + gr;
  const int wq0 = q0 + warp * 16;
  float m[2] = {-INFINITY, -INFINITY};  // running max, base-2 units
  float l[2] = {0.f, 0.f};              // this lane's part of the row sum
  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const T* qa = Qs + (warp * 16 + (lm & 1) * 8 + lr) * RS + (lm >> 1) * 8;
  const int b_off = ((lm >> 1) * 8 + lr) * RS + (lm & 1) * 8;   // [n][k]
  const int bt_off = ((lm & 1) * 8 + lr) * RS + (lm >> 1) * 8;  // [k][n]
  const float scale_log2 = scale * kLog2e;
  uint32_t aq[QREG ? KQ : 1][4];        // the warp's Q rows as A fragments

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) {
      load_tile(it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (QREG) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < KQ; ++kk) ldsm_x4(aq[kk], qa + kk * 16);
      }
    }
    const int k0 = it * kNK;
    const T* Kc = Ks + (it & 1) * kNK * RS;
    const T* Vc = Vs + (it & 1) * kNK * RS;

    // S = Q.K^T over the warp's 16 queries x kNK keys
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      uint32_t a[4];
      if constexpr (QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = aq[kk][e];
      } else {
        ldsm_x4(a, qa + kk * 16);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bk[4];
        ldsm_x4(bk, Kc + np * 16 * RS + kk * 16 + b_off);
        mma16816<T>(s[2 * np], a, bk[0], bk[1]);
        mma16816<T>(s[2 * np + 1], a, bk[2], bk[3]);
      }
    }

    // online softmax on the fragment: scores in base-2 units, the element
    // mask only where the diagonal or the ragged key edge crosses the tile
    const bool full = !(causal && k0 + kNK - 1 > wq0 + offset) && k0 + kNK <= Sk;
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (!full) {
          const int qi = qi0 + (e >> 1) * 8;
          const int kj = k0 + n * 8 + gc + (e & 1);
          if (!(kj < Sk && (!causal || kj <= qi + offset))) x = -INFINITY;
        }
        s[n][e] = x;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], x);
      }
    }
    float alpha[2], base[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      tmax[x] = fmaxf(tmax[x], __shfl_xor_sync(0xffffffffu, tmax[x], 1));
      tmax[x] = fmaxf(tmax[x], __shfl_xor_sync(0xffffffffu, tmax[x], 2));
      const float m_new = fmaxf(m[x], tmax[x]);
      // a row that has seen no visible key keeps m = -inf; subtracting 0
      // then gives exp2(-inf) = 0 instead of exp2(nan)
      base[x] = m_new == -INFINITY ? 0.f : m_new;
      alpha[x] = exp2f(m[x] - base[x]);
      m[x] = m_new;
      l[x] *= alpha[x];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - base[e >> 1]);
        s[n][e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];

    // O += P.V, P straight from registers, V by ldmatrix.trans
#pragma unroll
    for (int kq = 0; kq < kNK / 16; ++kq) {
      uint32_t ap[4];
      acc_to_a<T>(ap, s[2 * kq], s[2 * kq + 1]);
#pragma unroll
      for (int np = 0; np < DP / 16; ++np) {
        uint32_t bv[4];
        ldsm_x4_t(bv, Vc + kq * 16 * RS + np * 16 + bt_off);
        mma16816<T>(acc[2 * np], ap, bv[0], bv[1]);
        mma16816<T>(acc[2 * np + 1], ap, bv[2], bv[3]);
      }
    }
    __syncthreads();                    // this buffer is free to refill
  }

#pragma unroll
  for (int x = 0; x < 2; ++x) {
    l[x] += __shfl_xor_sync(0xffffffffu, l[x], 1);
    l[x] += __shfl_xor_sync(0xffffffffu, l[x], 2);
  }
  const bool pairs = D % 2 == 0;        // two adjacent columns per store
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int qi = qi0 + x * 8;
    if (qi >= Sq) continue;
    const float inv = l[x] > 0.f ? 1.f / l[x] : 0.f;
    T* orow = o + (static_cast<long long>(b) * Sq + qi) * H * D +
              static_cast<long long>(h) * D;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      const int d = n * 8 + gc;
      const float lo = acc[n][2 * x] * inv;
      const float hi = acc[n][2 * x + 1] * inv;
      if (pairs && d + 1 < D) {
        *reinterpret_cast<uint32_t*>(orow + d) = pack2<T>(lo, hi);
      } else {
        if (d < D) orow[d] = ptt::from_f32<T>(lo);
        if (d + 1 < D) orow[d + 1] = ptt::from_f32<T>(hi);
      }
    }
    // natural-log logsumexp, as K2 reads it
    if (lse != nullptr && lane % 4 == 0)
      lse[static_cast<long long>(bh) * Sq + qi] =
          l[x] > 0.f ? (m[x] + log2f(l[x])) / kLog2e : -INFINITY;
  }
}

// ------------------------------------------- f32: 3xTF32 tensor cores
// Tiling of the f32 body by padded head_dim: keys per streamed tile, warps
// per 16-query group (each owning DP / kSplit columns of O), and the
// padded f32 rows of the Q tile and the K and V rings
template <int DP>
struct F32Tc {
  static constexpr int kKeys = DP <= 64 ? 64 : 32;
  static constexpr int kSplit = DP <= 128 ? 1 : 2;
  // Q and K rows: the lanes' float2 fragment reads (8 rows x 4 column
  // pairs) on distinct banks; V row: the two-row scalar reads (4 row pairs
  // x 8 columns) on distinct banks; all 16-byte multiples for cp.async
  static constexpr int kKS = DP + 8;
  static constexpr int kVS = DP + 4;
  // the split's exchange: each warp's partial S, lane-major
  static constexpr int kXs = kSplit > 1 ? kSplit * kTcWarps * kKeys * 4 * 4 : 0;
  static constexpr size_t kSmem =
      sizeof(float) * (2 * kKeys * (kKS + kVS) + kTcM * kKS + kXs);
};

// The head_dim split (warps w and w + 4 on one 16-query group), K2a's
// exchange for S alone: each warp holds a partial S over its half of
// head_dim and adds its partner's, read through shared memory laid out
// lane-major (one bank a lane).  a + b == b + a, so both warps hold the
// same bits, and so the same m, l and P.
template <int NT>
__device__ __forceinline__ void add_partner(float (&s)[NT][4], float* xs,
                                            int warp, int lane) {
  float* mine = xs + warp * NT * 4 * 32 + lane;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) mine[(n * 4 + e) * 32] = s[n][e];
  __syncthreads();
  const float* other = xs + (warp ^ kTcWarps) * NT * 4 * 32 + lane;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] += other[(n * 4 + e) * 32];
}

// vec: bit i set when tensor i of (q, k, v) takes 16-byte copies.
template <int DP>
__global__ void __launch_bounds__(kTcThreads * F32Tc<DP>::kSplit)
flash_fwd_f32_tc_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o,
                        float* __restrict__ lse, int H, int Sq, int Sk, int D,
                        long long qsb, long long qss, long long qsh,
                        long long ksb, long long kss, long long ksh,
                        long long vsb, long long vss, long long vsh,
                        float scale, int causal, int vec) {
  constexpr int NK = F32Tc<DP>::kKeys;
  constexpr int DS = F32Tc<DP>::kSplit;
  constexpr int NTH = kTcThreads * DS;
  constexpr int KS = F32Tc<DP>::kKS;
  constexpr int VS = F32Tc<DP>::kVS;
  constexpr int NT = NK / 8;            // 8-key tiles of S (and k-steps of P.V)
  constexpr int DW = DP / DS;           // head dims of o (and of Q.K^T) per warp
  constexpr int DT = DW / 8;            // 8-wide tiles of them
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);   // [2][NK][KS]
  float* Vs = Ks + 2 * NK * KS;                      // [2][NK][VS]
  float* Qs = Vs + 2 * NK * VS;                      // [64][KS]
  float* Xs = Qs + kTcM * KS;                        // the split's exchange

  const int warp = threadIdx.x / 32 % kTcWarps;      // 16-query group
  const int dh = DS > 1 ? threadIdx.x / 32 / kTcWarps : 0;  // which DW columns
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;               // fragment row (and B column)
  const int t = lane % 4;               // fragment column pair
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  // the last query tile sees the most keys: it goes out first
  const int q0 =
      ((Sq + kTcM - 1) / kTcM - 1 - static_cast<int>(blockIdx.y)) * kTcM;
  const int offset = Sk - Sq;

  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + h * ksh;
  const float* vb = v + b * vsb + h * vsh;

  const int kend = causal ? min(Sk, min(q0 + kTcM, Sq) + offset) : Sk;
  const int ntiles = (kend + NK - 1) / NK;

  auto load_tile = [&](int it) {
    const int buf = it & 1;
    stage_tc<float, NK, DP, KS, NTH>(Ks + buf * NK * KS, kb, kss, it * NK, Sk,
                                     D, vec & 2);
    stage_tc<float, NK, DP, VS, NTH>(Vs + buf * NK * VS, vb, vss, it * NK, Sk,
                                     D, vec & 4);
  };
  stage_tc<float, kTcM, DP, KS, NTH>(Qs, qb, qss, q0, Sq, D, vec & 1);
  load_tile(0);
  cp_async_commit();

  // This lane's two query rows.  The reduction over head_dim does not
  // depend on its order, so k-step kk takes the columns in the order
  // 8 kk + (0, 2, 4, 6, 1, 3, 5, 7): fragment columns t and t + 4 are the
  // adjacent head dims 8 kk + 2t and 8 kk + 2t + 1, one float2 of Q and
  // one of K.  Q stays in shared memory as f32 and is split into TF32
  // halves at each k-step (held in registers, Q would push the 128-wide
  // body past 255 registers into spills).
  const int qi0 = q0 + warp * 16 + g;
  const int wq0 = q0 + warp * 16;
  const float* qr = Qs + (warp * 16 + g) * KS + dh * DW + 2 * t;
  float m[2] = {-INFINITY, -INFINITY};  // running max, base-2 units
  float l[2] = {0.f, 0.f};              // this lane's part of the row sum
  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const float scale_log2 = scale * kLog2e;

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) {
      load_tile(it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = it * NK;
    const float* Kc = Ks + (it & 1) * NK * KS;
    const float* Vc = Vs + (it & 1) * NK * VS;

    // S = Q.K^T over the warp's 16 queries x NK keys (with the split: over
    // this warp's DW head dims, plus its partner's partial; its k-steps
    // unrolled by 8, not all 16: see the header's times)
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll (DS > 1 ? 8 : DT)
    for (int kk = 0; kk < DT; ++kk) {
      const float2 q_lo = *reinterpret_cast<const float2*>(qr + kk * 8);
      const float2 q_hi =
          *reinterpret_cast<const float2*>(qr + 8 * KS + kk * 8);
      const Tf32Frag aq = split_frag(q_lo.x, q_hi.x, q_lo.y, q_hi.y);
      const float* kr = Kc + g * KS + dh * DW + kk * 8 + 2 * t;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float2 kv = *reinterpret_cast<const float2*>(kr + n * 8 * KS);
        mma1688_3xtf32(s[n], aq, kv.x, kv.y);
      }
    }
    if constexpr (DS > 1) add_partner<NT>(s, Xs, warp + dh * kTcWarps, lane);

    // online softmax on the fragment, as the 16-bit body: scores in
    // base-2 units, the element mask only where the diagonal or the
    // ragged key edge crosses the tile
    const bool full = !(causal && k0 + NK - 1 > wq0 + offset) && k0 + NK <= Sk;
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (!full) {
          const int qi = qi0 + (e >> 1) * 8;
          const int kj = k0 + n * 8 + 2 * t + (e & 1);
          if (!(kj < Sk && (!causal || kj <= qi + offset))) x = -INFINITY;
        }
        s[n][e] = x;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], x);
      }
    }
    float alpha[2], base[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      tmax[x] = fmaxf(tmax[x], __shfl_xor_sync(0xffffffffu, tmax[x], 1));
      tmax[x] = fmaxf(tmax[x], __shfl_xor_sync(0xffffffffu, tmax[x], 2));
      const float m_new = fmaxf(m[x], tmax[x]);
      // a row that has seen no visible key keeps m = -inf; subtracting 0
      // then gives exp2(-inf) = 0 instead of exp2(nan)
      base[x] = m_new == -INFINITY ? 0.f : m_new;
      alpha[x] = exp2f(m[x] - base[x]);
      m[x] = m_new;
      l[x] *= alpha[x];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - base[e >> 1]);
        s[n][e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];

    // O += P.V.  k-step kq takes the keys in the order kq 8 + (0, 2, 4, 6,
    // 1, 3, 5, 7): fragment columns t and t + 4 are keys 2t and 2t + 1,
    // which the accumulator of S tile kq already holds in this lane, so P
    // is the A operand as it stands (p in [0, 1] splits cleanly); V's B
    // fragment reads rows 2t and 2t + 1 to match.
#pragma unroll
    for (int kq = 0; kq < NT; ++kq) {
      const Tf32Frag ap = split_frag(s[kq][0], s[kq][2], s[kq][1], s[kq][3]);
      const float* vr = Vc + (kq * 8 + 2 * t) * VS + dh * DW + g;
#pragma unroll
      for (int n = 0; n < DT; ++n)
        mma1688_3xtf32(acc[n], ap, vr[n * 8], vr[VS + n * 8]);
    }
    __syncthreads();                    // this buffer is free to refill
  }

#pragma unroll
  for (int x = 0; x < 2; ++x) {
    l[x] += __shfl_xor_sync(0xffffffffu, l[x], 1);
    l[x] += __shfl_xor_sync(0xffffffffu, l[x], 2);
  }
  const bool pairs = D % 2 == 0;        // two adjacent columns per store
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int qi = qi0 + x * 8;
    if (qi >= Sq) continue;
    const float inv = l[x] > 0.f ? 1.f / l[x] : 0.f;
    float* orow = o + (static_cast<long long>(b) * Sq + qi) * H * D +
                  static_cast<long long>(h) * D;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      const int d = dh * DW + n * 8 + 2 * t;
      const float lo = acc[n][2 * x] * inv;
      const float hi = acc[n][2 * x + 1] * inv;
      if (pairs && d + 1 < D) {
        *reinterpret_cast<float2*>(orow + d) = make_float2(lo, hi);
      } else {
        if (d < D) orow[d] = lo;
        if (d + 1 < D) orow[d + 1] = hi;
      }
    }
    // natural-log logsumexp, as the 16-bit body and K2 have it (a split
    // pair holds the same m and l: its first warp writes it)
    if (lse != nullptr && t == 0 && dh == 0)
      lse[static_cast<long long>(bh) * Sq + qi] =
          l[x] > 0.f ? (m[x] + log2f(l[x])) / kLog2e : -INFINITY;
  }
}

template <typename T, int DP>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      float* lse, int B, int H, int Sq, int Sk, int D,
                      const long long* st, float scale, int causal,
                      cudaStream_t stream) {
  auto kernel = flash_fwd_tc_kernel<T, DP>;
  const size_t smem = tc_smem_bytes<DP>(sizeof(T));
  cudaError_t err = ptt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const void* x[3] = {q, k, v};
  const int vec = vec_mask(x, 3, st, D, sizeof(T));
  dim3 grid(B * H, (Sq + kTcM - 1) / kTcM);
  kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, Sq, Sk, D,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      scale, causal, vec);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_f32_tc(const void* q, const void* k, const void* v,
                          void* o, float* lse, int B, int H, int Sq, int Sk,
                          int D, const long long* st, float scale, int causal,
                          cudaStream_t stream) {
  auto kernel = flash_fwd_f32_tc_kernel<DP>;
  const size_t smem = F32Tc<DP>::kSmem;
  cudaError_t err = ptt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const void* x[3] = {q, k, v};
  const int vec = vec_mask(x, 3, st, D, sizeof(float));
  dim3 grid(B * H, (Sq + kTcM - 1) / kTcM);
  kernel<<<grid, kTcThreads * F32Tc<DP>::kSplit, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, H, Sq, Sk, D,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      scale, causal, vec);
  return cudaGetLastError();
}

// The body that takes a call: every head_dim runs on the tensor cores,
// f32 by 3xTF32, bf16 / f16 by 16-bit products.  The numbers are the
// backward's (csrc/flash_attention_bwd.cu BwdBody), and the wrapper counts
// launches by them.
enum FwdBody : int { kFwdTc16 = 1, kFwdTf32 = 2 };

int fwd_body(int dtype) {
  return dtype == ptt::kF32 ? kFwdTf32 : kFwdTc16;
}

}  // namespace

namespace ptt {
namespace fa_fwd {

// T is the C++ type of dtype code `dtype`; head_dim D is padded to DP =
// 64, 128 or 256.
template <typename T>
cudaError_t run(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int H, int Sq, int Sk, int D,
                const long long* st, float scale, int causal, cudaStream_t s) {
  auto launch = [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    if constexpr (std::is_same<T, float>::value)
      return launch_f32_tc<DP>(q, k, v, o, lse, B, H, Sq, Sk, D, st, scale,
                               causal, s);
    else
      return launch_tc<T, DP>(q, k, v, o, lse, B, H, Sq, Sk, D, st, scale,
                              causal, s);
  };
  if (D <= 64) return launch(std::integral_constant<int, 64>());
  if (D <= 128) return launch(std::integral_constant<int, 128>());
  return launch(std::integral_constant<int, 256>());
}

}  // namespace fa_fwd
}  // namespace ptt

// Built in three parts (ops/_build.py): part p instantiates the dtype of
// code p (common.cuh DType); part 0 also holds the entries.
#define PTT_FA_FWD_RUN(EXTERN, T)                                            \
  EXTERN template cudaError_t ptt::fa_fwd::run<T>(                           \
      const void*, const void*, const void*, void*, float*, int, int, int,   \
      int, int, const long long*, float, int, cudaStream_t);
#if PTT_PART == 0
PTT_FA_FWD_RUN(, float)
#elif PTT_PART > 0
PTT_FA_FWD_RUN(extern, float)
#endif
#if PTT_PART == 1
PTT_FA_FWD_RUN(, __half)
#elif PTT_PART >= 0
PTT_FA_FWD_RUN(extern, __half)
#endif
#if PTT_PART == 2
PTT_FA_FWD_RUN(, __nv_bfloat16)
#elif PTT_PART >= 0
PTT_FA_FWD_RUN(extern, __nv_bfloat16)
#endif

#if PTT_PART <= 0

// q/k/v: [B, S, H, D] with element strides (batch, seq, head) in `strides`
// (q, k, v in that order; the head dim is unit-stride).  o: contiguous
// [B, Sq, H, D] in the input dtype.  lse: [B * H, Sq] f32, or null.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int ptt_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       int dtype, int B, int H, int Sq, int Sk,
                                       int D, const long long* strides,
                                       float scale, int causal, void* stream) {
  if (D < 1 || D > 256 || B < 1 || H < 1 || Sq < 1 || Sk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  cudaError_t err = cudaSuccess;
  PTT_DISPATCH_DTYPE(dtype, {
    err = ptt::fa_fwd::run<scalar_t>(q, k, v, o, lse_f, B, H, Sq, Sk, D,
                                     strides, scale, causal, s);
  });
  return static_cast<int>(err);
}

// The body ptt_flash_attention_fwd launches for (dtype, D): 1 the 16-bit
// tensor cores, 2 3xTF32 (the wrapper counts launches per body).
extern "C" int ptt_flash_attention_fwd_body(int dtype, int D) {
  (void)D;
  return fwd_body(dtype);
}
#endif  // PTT_PART <= 0
