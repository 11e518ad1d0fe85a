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
// bf16 / f16 design, head_dim <= 128 (the served and trained paths), after
// FlashAttention-2's forward and built from K2b's parts (mma.cuh): one
// block of 4 warps per (64-query tile, batch * head); each warp owns 16
// query rows.  Q is staged once in shared memory in the input dtype and
// held as mma A fragments in registers; 64-key tiles of K and V stream
// through a double-buffered ring by 16-byte cp.async.cg (the next tile
// loads while the current one is computed) up to the causal bound.
// S = Q.K^T is mma.sync.m16n8k16 fed by ldmatrix; the running max, the
// rescale and the row sum work on the accumulator fragment in registers
// (base-2 exponent, reduced over the four lanes of a row by two shuffles);
// P is rounded to the input dtype in registers and is the A operand of
// O += P.V, with V read by ldmatrix.trans: no score goes through shared
// memory.  Rows are padded by 16 bytes so ldmatrix hits distinct banks;
// head_dim is zero-padded to 64 or 128.  The element mask runs only on
// tiles that the diagonal or the ragged key edge crosses.  The last query
// tile, which sees the most keys, goes out first, with batch * head as the
// fast grid axis.  Tensors that cannot take 16-byte copies (D * 2 not a
// multiple of 16, a misaligned base or stride) are staged by a scalar loop
// in the same kernel, chosen per tensor by vec_mask.
//
// f32 design, head_dim <= 128 (Llama's f32 prefill, every f32 card-vs-CPU
// gate of the GPT phases): the same structure on the tensor cores by
// 3xTF32.  Each f32 operand is split into a TF32 big part and a TF32 small
// remainder (mma.cuh split_tf32: big rounded to nearest by two integer
// ops -- cvt.rna.tf32.f32 compiles to a longer integer, compare and
// select sequence on sm_90a, which set the pace of this body's first
// version; small = x - big, whose top 19 bits the mma reads) and every
// product is a_small.b_big + a_big.b_small + a_big.b_big, three
// mma.sync.m16n8k8 TF32 products accumulated in f32: about 2^-21 relative
// per product, at up to 495 / 3 = 165 TFLOP/s against the 67 TFLOP/s
// SIMT rate.  Its bound is 3 x the
// operations at the TF32 rate.  4 warps per (64-query tile, batch *
// head), each warp 16 query rows; Q is staged once in shared memory, and
// K and V tiles (64 keys at head_dim <= 64, 32 at <= 128: 88 / 101 KB of
// shared memory with Q, two blocks per SM) stream through a
// double-buffered ring by 16-byte cp.async.cg into f32 rows padded
// against bank conflicts (Q and K rows DP + 8 for the float2 fragment
// reads, V rows DP + 4 for the two-row reads).  TF32 fragments are
// 32-bit, so there is no ldmatrix: fragments come from plain shared
// loads, and both reductions take their k dimension in the order (0, 2,
// 4, 6, 1, 3, 5, 7) within each 8-wide step, which the sums do not depend
// on.  Then fragment columns t and t+4 are adjacent head dims (one float2
// of Q and of K per lane), and for P.V they are the keys 2t and 2t+1 that
// the S accumulator already holds in the lane: P is the A operand as it
// stands, with no shuffle.  The online softmax, the causal mask and the
// heaviest-tile-first order are the 16-bit body's.  Registers and spills
// of each instantiation: chip_smoke.py's build line (PERF.md).
//
// bf16 / f16 / f32 with 128 < head_dim <= 256 (no path of the repository
// runs those: GPT-base has D = 64, Llama D = 128): the SIMT body, one
// block of 256 threads per (64-row query tile, batch * head); the key
// tiles are staged as f32 in shared memory; four threads own one query
// row, each computing 16 of the tile's 64 scores with plain f32 FMAs and
// D/4 output columns; row max and row sum are reduced with two warp
// shuffles.
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

// ------------------------------------------------------------ SIMT body

constexpr int kBQ = 64;                 // query rows per block
constexpr int kBK = 64;                 // keys per staged tile
constexpr int kThreads = 256;
constexpr int kTPR = kThreads / kBQ;    // threads per query row (4)
constexpr int kCols = kBK / kTPR;       // scores per thread per tile (16)

template <int DP>
constexpr size_t smem_bytes() {
  // Q [BQ][DP+1], K [BK][DP+1], V [BK][DP], P [BQ][BK+1]; the +1 pads
  // keep the row-strided reads free of bank conflicts
  return sizeof(float) *
         (kBQ * (DP + 1) + kBK * (DP + 1) + kBK * DP + kBQ * (kBK + 1));
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int Sq, int Sk, int D,
                 long long qsb, long long qss, long long qsh,
                 long long ksb, long long kss, long long ksh,
                 long long vsb, long long vss, long long vsh,
                 float scale, int causal) {
  constexpr int QS = DP + 1;
  constexpr int KS = DP + 1;
  constexpr int PS = kBK + 1;
  constexpr int DPT = DP / kTPR;        // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * QS;
  float* Vs = Ks + kBK * KS;
  float* Ps = Vs + kBK * DP;

  const int tid = threadIdx.x;
  const int r = tid / kTPR;             // this thread's row in the tile
  const int sub = tid % kTPR;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * kBQ;
  const int qi = q0 + r;
  const int offset = Sk - Sq;

  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + h * ksh;
  const T* vb = v + b * vsb + h * vsh;

  for (int idx = tid; idx < kBQ * DP; idx += kThreads) {
    const int rr = idx / DP;
    const int d = idx % DP;
    const int row = q0 + rr;
    Qs[rr * QS + d] = (row < Sq && d < D) ? ptt::to_f32(qb[row * qss + d]) : 0.f;
  }

  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;
  float m = -INFINITY;
  float l = 0.f;

  // causal: the tile's last valid row sees keys up to q_last + offset
  int kend = Sk;
  if (causal) kend = min(Sk, min(q0 + kBQ, Sq) - 1 + offset + 1);

  for (int k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();                    // Q staged / last tile consumed
    for (int idx = tid; idx < kBK * DP; idx += kThreads) {
      const int j = idx / DP;
      const int d = idx % DP;
      const int kj = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (kj < Sk && d < D) {
        kx = ptt::to_f32(kb[kj * kss + d]);
        vx = ptt::to_f32(vb[kj * vss + d]);
      }
      Ks[j * KS + d] = kx;
      Vs[j * DP + d] = vx;
    }
    __syncthreads();

    float s[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) s[c] = 0.f;
    const float* qrow = Qs + r * QS;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      const float qd = qrow[d];
#pragma unroll
      for (int c = 0; c < kCols; ++c) s[c] += qd * Ks[(sub + c * kTPR) * KS + d];
    }
    float tmax = -INFINITY;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int kj = k0 + sub + c * kTPR;
      const bool ok = kj < Sk && (!causal || kj <= qi + offset);
      s[c] = ok ? s[c] * scale : -INFINITY;
      tmax = fmaxf(tmax, s[c]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    // a row that has seen no visible key yet keeps m = -inf; subtracting
    // 0 then gives exp(-inf) = 0 instead of exp(nan)
    const float base = (m_new == -INFINITY) ? 0.f : m_new;
    const float alpha = __expf(m - base);
    float psum = 0.f;
    float* prow = Ps + r * PS;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const float p = __expf(s[c] - base);
      prow[sub + c * kTPR] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();                       // the row's 4 threads share a warp
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float p = prow[j];
      const float* vrow = Vs + j * DP;
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] += p * vrow[sub + i * kTPR];
    }
  }

  if (qi < Sq) {
    const float inv = l > 0.f ? 1.f / l : 0.f;
    T* orow = o + (static_cast<long long>(b) * Sq + qi) * H * D +
              static_cast<long long>(h) * D;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = sub + i * kTPR;
      if (d < D) orow[d] = ptt::from_f32<T>(acc[i] * inv);
    }
    if (lse != nullptr && sub == 0)
      lse[static_cast<long long>(bh) * Sq + qi] = l > 0.f ? m + logf(l) : -INFINITY;
  }
}

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
  uint32_t aq[KQ][4];                   // the warp's Q rows as A fragments

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) {
      load_tile(it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) ldsm_x4(aq[kk], qa + kk * 16);
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
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bk[4];
        ldsm_x4(bk, Kc + np * 16 * RS + kk * 16 + b_off);
        mma16816<T>(s[2 * np], aq[kk], bk[0], bk[1]);
        mma16816<T>(s[2 * np + 1], aq[kk], bk[2], bk[3]);
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
    // natural-log logsumexp, as the SIMT body and K2 have it
    if (lse != nullptr && lane % 4 == 0)
      lse[static_cast<long long>(bh) * Sq + qi] =
          l[x] > 0.f ? (m[x] + log2f(l[x])) / kLog2e : -INFINITY;
  }
}

// ------------------------------------------- f32: 3xTF32 tensor cores
// keys per streamed tile, and the padded f32 rows of the Q tile and the K
// and V rings
template <int DP>
struct F32Tc {
  static constexpr int kKeys = DP <= 64 ? 64 : 32;
  // Q and K rows: the lanes' float2 fragment reads (8 rows x 4 column
  // pairs) on distinct banks; V row: the two-row scalar reads (4 row pairs
  // x 8 columns) on distinct banks; all 16-byte multiples for cp.async
  static constexpr int kKS = DP + 8;
  static constexpr int kVS = DP + 4;
  static constexpr size_t kSmem =
      sizeof(float) * (2 * kKeys * (kKS + kVS) + kTcM * kKS);
};

// vec: bit i set when tensor i of (q, k, v) takes 16-byte copies.
template <int DP>
__global__ void __launch_bounds__(kTcThreads)
flash_fwd_f32_tc_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o,
                        float* __restrict__ lse, int H, int Sq, int Sk, int D,
                        long long qsb, long long qss, long long qsh,
                        long long ksb, long long kss, long long ksh,
                        long long vsb, long long vss, long long vsh,
                        float scale, int causal, int vec) {
  constexpr int NK = F32Tc<DP>::kKeys;
  constexpr int KS = F32Tc<DP>::kKS;
  constexpr int VS = F32Tc<DP>::kVS;
  constexpr int NT = NK / 8;            // 8-key tiles of S (and k-steps of P.V)
  constexpr int DT = DP / 8;            // 8-wide tiles of o (and k-steps of Q.K^T)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);   // [2][NK][KS]
  float* Vs = Ks + 2 * NK * KS;                      // [2][NK][VS]
  float* Qs = Vs + 2 * NK * VS;                      // [64][KS]

  const int warp = threadIdx.x / 32;
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
    stage_tc<float, NK, DP, KS>(Ks + buf * NK * KS, kb, kss, it * NK, Sk, D,
                                vec & 2);
    stage_tc<float, NK, DP, VS>(Vs + buf * NK * VS, vb, vss, it * NK, Sk, D,
                                vec & 4);
  };
  stage_tc<float, kTcM, DP, KS>(Qs, qb, qss, q0, Sq, D, vec & 1);
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
  const float* qr = Qs + (warp * 16 + g) * KS + 2 * t;
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

    // S = Q.K^T over the warp's 16 queries x NK keys
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DT; ++kk) {
      const float2 q_lo = *reinterpret_cast<const float2*>(qr + kk * 8);
      const float2 q_hi =
          *reinterpret_cast<const float2*>(qr + 8 * KS + kk * 8);
      const Tf32Frag aq = split_frag(q_lo.x, q_hi.x, q_lo.y, q_hi.y);
      const float* kr = Kc + g * KS + kk * 8 + 2 * t;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float2 kv = *reinterpret_cast<const float2*>(kr + n * 8 * KS);
        mma1688_3xtf32(s[n], aq, kv.x, kv.y);
      }
    }

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
      const float* vr = Vc + (kq * 8 + 2 * t) * VS + g;
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
      const int d = n * 8 + 2 * t;
      const float lo = acc[n][2 * x] * inv;
      const float hi = acc[n][2 * x + 1] * inv;
      if (pairs && d + 1 < D) {
        *reinterpret_cast<float2*>(orow + d) = make_float2(lo, hi);
      } else {
        if (d < D) orow[d] = lo;
        if (d + 1 < D) orow[d + 1] = hi;
      }
    }
    // natural-log logsumexp, as the other bodies and K2 have it
    if (lse != nullptr && t == 0)
      lse[static_cast<long long>(bh) * Sq + qi] =
          l[x] > 0.f ? (m[x] + log2f(l[x])) / kLog2e : -INFINITY;
  }
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int H, int Sq, int Sk, int D,
                   const long long* st, float scale, int causal,
                   cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, DP>;
  const size_t smem = smem_bytes<DP>();
  cudaError_t err = ptt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, Sq, Sk, D,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      scale, causal);
  return cudaGetLastError();
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
  kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, H, Sq, Sk, D,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      scale, causal, vec);
  return cudaGetLastError();
}

// The body that takes a call: head_dim <= 128 the tensor cores (head_dim
// padded to 64 or 128), f32 by 3xTF32, bf16 / f16 by 16-bit products;
// 128 < head_dim <= 256 the SIMT body in every dtype (padded to 256).
// run launches the body this rule names, and the wrapper counts launches
// by it.
enum FwdBody : int { kFwdSimt = 0, kFwdTc16 = 1, kFwdTf32 = 2 };

int fwd_body(int dtype, int D) {
  if (D > 128) return kFwdSimt;
  return dtype == ptt::kF32 ? kFwdTf32 : kFwdTc16;
}

// T is the C++ type of dtype code `dtype`.
template <typename T>
cudaError_t run(int dtype, const void* q, const void* k, const void* v,
                void* o, float* lse, int B, int H, int Sq, int Sk, int D,
                const long long* st, float scale, int causal, cudaStream_t s) {
  switch (fwd_body(dtype, D)) {
    case kFwdSimt:
      return launch<T, 256>(q, k, v, o, lse, B, H, Sq, Sk, D, st, scale,
                            causal, s);
    case kFwdTf32:
      if constexpr (std::is_same<T, float>::value)
        return D <= 64 ? launch_f32_tc<64>(q, k, v, o, lse, B, H, Sq, Sk, D,
                                           st, scale, causal, s)
                       : launch_f32_tc<128>(q, k, v, o, lse, B, H, Sq, Sk, D,
                                            st, scale, causal, s);
      break;
    case kFwdTc16:
      if constexpr (!std::is_same<T, float>::value)
        return D <= 64 ? launch_tc<T, 64>(q, k, v, o, lse, B, H, Sq, Sk, D,
                                          st, scale, causal, s)
                       : launch_tc<T, 128>(q, k, v, o, lse, B, H, Sq, Sk, D,
                                           st, scale, causal, s);
      break;
  }
  return cudaErrorInvalidValue;         // a body this dtype has no build of
}

}  // namespace

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
    err = run<scalar_t>(dtype, q, k, v, o, lse_f, B, H, Sq, Sk, D, strides,
                        scale, causal, s);
  });
  return static_cast<int>(err);
}

// The body ptt_flash_attention_fwd launches for (dtype, D): 0 SIMT, 1 the
// 16-bit tensor cores, 2 3xTF32 (the wrapper counts launches per body).
extern "C" int ptt_flash_attention_fwd_body(int dtype, int D) {
  return fwd_body(dtype, D);
}
