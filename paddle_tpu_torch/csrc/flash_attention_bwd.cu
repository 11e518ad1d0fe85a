// K2a / K2b: flash attention backward, written by hand for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of paddle_tpu/ops/flash_attention.py:
//   K2a _fa_bwd_dkdv_kernel (flash_attention.py:171, pallas_call at :276)
//   K2b _fa_bwd_dq_kernel   (flash_attention.py:218, pallas_call at :307)
// Same function: the probabilities are recomputed from the forward's saved
// per-row logsumexp, p = exp(q.k^T * scale - lse), masked bottom-right
// causal (key j is visible to query i when j <= i + (Sk - Sq)); with the
// row correction r = delta - g_lse (delta = sum(g * o), computed by the
// wrapper as the TPU package computes it outside its kernels):
//   dp = g.v^T,  ds = p * (dp - r) * scale,
//   dv = p^T.g,  dk = ds^T.q  (K2a),  dq = ds.k  (K2b),
// all accumulated in f32 and written once, in the input dtype, as
// contiguous [B, S, H, D].  No atomics: every output element has one
// owner and every sum runs in a fixed order, so two launches on the same
// inputs give the same bits.
//
// What bounds it on this card: per visible (query, key) pair K2a does four
// D-long products (s, dp, dv, dk: 8*D operations) and K2b three (s, dp,
// dq: 6*D) against a few bytes per row, so at the training shape (S =
// 1024, D = 64) both are far above the H100's ~295 operations per byte: a
// good kernel is bound by operations, at the 989 TFLOP/s bf16 / f16
// tensor-core rate, and in f32 by three TF32 products per product at the
// 495 TFLOP/s TF32 rate.
//
// Every dtype and head_dim 1-256 runs on the tensor cores, after
// FlashAttention-2's backward (one body per dtype class; head_dim is
// zero-padded to DP = 64, 128 or 256).  A block keeps a 64-row tile
// resident; each 16-row group of it belongs to one warp (two in K2a at
// DP = 256 and in the f32 K2a at DP = 128, see below), which sweeps the
// streamed tiles:
//   K2a: grid (batch * head, 64-key tile).  K and V stay in shared
//        memory; the loop streams the visible query tiles (q, g, lse, r).
//        With keys as the M dimension the warp computes S^T = K.Q^T and
//        dP^T = V.G^T, and the P^T and dS^T accumulator fragments serve
//        directly as the A operand of dV += P^T.G and dK += dS^T.Q: no
//        score round-trips through shared memory.
//   K2b: grid (batch * head, 64-query tile).  Q, G, and the warp's lse /
//        r rows stay resident; the loop streams key tiles of K and V up
//        to the causal bound.  dS goes from registers into dQ += dS.K.
// Streamed tiles come through a double-buffered ring of cp.async copies
// (the next tile loads while the current one is computed), 16 bytes a
// copy where a tensor allows (vec_mask), else a scalar loop in the same
// kernel.  q/k/v/g are read in the public [B, S, H, D] layout from their
// strides (unit stride in head_dim), so the model's head-major qkv split
// needs no copy; ragged tiles are zero-filled and masked, and the element
// mask runs only on tiles that the causal diagonal or a ragged edge
// crosses (tiles wholly above the diagonal are never visited).  The tile
// with the most work goes out first: the first key tile in K2a, the last
// query tile in K2b, with batch * head as the fast grid axis so each wave
// takes the heaviest tiles of every head.
//
// bf16 / f16 (the training path's bf16 under AMP O2): mma.sync.m16n8k16
// (16-bit inputs, f32 accumulators) fed by ldmatrix (.trans for the
// second products' B) out of tiles in the input dtype, rows padded by 16
// bytes so ldmatrix's eight row reads hit distinct banks; p and ds are
// rounded to the input dtype before their second product, as PyTorch's
// flash backward does.
//
// f32 (paddle's default dtype: every f32 training step and the f32
// card-vs-CPU parity gates): 3xTF32 (mma.cuh), each f32 operand split into
// a TF32 big part and a TF32 small remainder and every product a_small.
// b_big + a_big.b_small + a_big.b_big, three mma.sync.m16n8k8 TF32
// products accumulated in f32: about 2^-21 relative per product, where one
// TF32 pass keeps 2^-11.  p and ds stay f32.  TF32 fragments are 32-bit,
// so there is no ldmatrix: fragments are plain shared loads out of f32
// tiles whose rows are padded to DP + 4 floats.  The first products (S^T
// and dP^T, K2b's S and dP) reduce over head_dim in its natural order:
// lane (g, t) reads column t and t + 4 of rows g and g + 8, on 32 distinct
// banks.  The second products reduce over the query (K2a) or key (K2b)
// index and take each 8-wide k step in the order (0, 2, 4, 6, 1, 3, 5, 7),
// as K1's f32 body does: fragment columns t and t + 4 are then the
// indices 2t and 2t + 1 that the first product's accumulator already
// holds in the lane, so it is the A operand as it stands, and the B
// fragment is two row reads (rows 2t, 2t + 1, column g), again on
// distinct banks with the DP + 4 pad.
//
// Tiles, chosen so ptxas keeps every accumulator in registers (the build
// line of chip_smoke.py lists each instantiation's registers and spills;
// H100, nvcc 12.8):
//             K2a: query rows, warps,   K2b: key rows,   shared memory
//                  registers            registers        K2a / K2b
//   16-bit 64      64, 4, 236           64, 128 (4 B     55.0 / 54.0 KB
//                                       spilled)
//   16-bit 128     32, 4, 253           64, 168          68.5 / 102.0 KB
//   16-bit 256     32, 8, 246           32, 250          164.5 / 132.0 KB
//   f32 64         64, 4, 237           64, 168          103.0 / 102.0 KB
//   f32 128        32, 8, 209           32, 167          164.5 / 132.0 KB
//   f32 256         8, 8, 252           16, 248          170.6 / 195.0 KB
// A warp that owned 16 keys x 256 columns of both dK and dV would hold
// 256 f32 accumulators a thread, past the 255 registers a thread may
// have, and the f32 K2a at DP = 128 with one warp per group spilled 72
// bytes at 255 registers.  So there K2a runs 8 warps, two per 16-key
// group (warps w and w ^ 4), each owning half of head_dim of dK and dV.
// S^T and dP^T need the full head_dim reduction: each warp of a pair sums
// its own half and adds its partner's partial through shared memory (one
// more __syncthreads a tile).  The other way, each warp recomputing the
// whole reduction (with 16-query tiles in f32 at DP = 256), ran 11-12%
// slower at head_dim 256 and was taken out (K2a at [2, 1024, 8, 256]
// causal: bf16 0.1554-0.1559 against 0.1393-0.1399 ms, f32 0.5599-0.5604
// against 0.4981-0.5001; H100 80GB HBM3, 700 W).  K2b keeps 4 warps at
// DP = 256 with 16- or 32-key tiles (dQ is 128 accumulators a thread):
// the same split on 8 warps moved its time by no more than the spread
// between runs.
#include "common.cuh"
#include "mma.cuh"

#include <math.h>
#include <type_traits>

namespace {

using namespace ptt::tc;

struct Ptrs {
  long long sb, ss, sh;                 // element strides: batch, seq, head
};

// Tiling by dtype class and padded head_dim: NQ queries per streamed tile
// of K2a, NK keys per streamed tile of K2b, DS warps per 16-key group of
// K2a (each owning DP / DS columns of dK and dV).
template <bool F32, int DP>
struct Tiles {
  static constexpr int NQ = DP == 64 ? 64 : (F32 && DP == 256 ? 8 : 32);
  static constexpr int NK = DP == 64 ? 64 : (DP == 128 ? (F32 ? 32 : 64)
                                                       : (F32 ? 16 : 32));
  static constexpr int DS = DP == 256 || (F32 && DP == 128) ? 2 : 1;
};

// ------------------------------------------------ shared by both bodies
// K2a's P^T (into s) and dS^T (into dp) in place of S^T and dP^T on a
// warp's [16 keys][NT x 8 queries] accumulator tiles: this lane holds keys
// kj0 and kj0 + 8 and query columns gc, gc + 1 of each 8-tile.  The
// element mask runs only where `full` is false.
template <int NT>
__device__ __forceinline__ void dkdv_probs(float (&s)[NT][4],
                                           float (&dp)[NT][4],
                                           const float* Lc, const float* Rc,
                                           int q0, int kj0, int gc, bool full,
                                           int Sq, int Sk, int offset,
                                           int causal, float scale) {
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ci = n * 8 + gc + (e & 1);
      float p = exp2f((s[n][e] * scale - Lc[ci]) * kLog2e);
      if (!full) {
        const int qi = q0 + ci;
        const int kj = kj0 + (e >> 1) * 8;
        if (!(qi < Sq && kj < Sk && (!causal || kj <= qi + offset))) p = 0.f;
      }
      s[n][e] = p;
      dp[n][e] = p * (dp[n][e] - Rc[ci]) * scale;
    }
  }
}

// K2b's dS in place of dP on a warp's [16 queries][NT x 8 keys] tiles:
// this lane holds queries qi0 and qi0 + 8 (their lse in base-2 units and
// their r in lrow / rrow) and key columns gc, gc + 1 of each 8-tile.
template <int NT>
__device__ __forceinline__ void dq_scores(const float (&s)[NT][4],
                                          float (&dp)[NT][4],
                                          const float (&lrow)[2],
                                          const float (&rrow)[2], int qi0,
                                          int k0, int gc, bool full, int Sq,
                                          int Sk, int offset, int causal,
                                          float scale) {
  const float scale_log2 = scale * kLog2e;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int x = e >> 1;
      float p = exp2f(s[n][e] * scale_log2 - lrow[x]);
      if (!full) {
        const int qi = qi0 + x * 8;
        const int kj = k0 + n * 8 + gc + (e & 1);
        if (!(qi < Sq && kj < Sk && (!causal || kj <= qi + offset))) p = 0.f;
      }
      dp[n][e] = p * (dp[n][e] - rrow[x]) * scale;
    }
  }
}

// The D split of K2a (8 warps, warp w and w ^ 4 on one 16-key group): each
// warp holds a partial S^T / dP^T over its half of head_dim and adds its
// partner's, read through shared memory laid out lane-major (each access
// one bank a lane).  a + b == b + a, so both warps hold the same bits.
template <int NT>
__device__ __forceinline__ void add_partner(float (&s)[NT][4],
                                            float (&dp)[NT][4], float* xs,
                                            int warp, int lane) {
  constexpr int W = 2 * NT * 4;         // floats per lane
  float* mine = xs + warp * W * 32 + lane;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      mine[(n * 4 + e) * 32] = s[n][e];
      mine[((NT + n) * 4 + e) * 32] = dp[n][e];
    }
  }
  __syncthreads();
  const float* other = xs + (warp ^ kTcWarps) * W * 32 + lane;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[n][e] += other[(n * 4 + e) * 32];
      dp[n][e] += other[((NT + n) * 4 + e) * 32];
    }
  }
}

// Write a warp's [16 rows][DT x 8 columns] f32 accumulator tiles (rows r0
// and r0 + 8 in this lane, columns c0 + 8 n + gc and + 1) into rows of a
// contiguous [B, S, H, D] output in T.
template <typename T, int DT>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[DT][4],
                                           int b, int h, int H, int S, int D,
                                           int r0, int c0, int gc) {
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int row = r0 + x * 8;
    if (row >= S) continue;
    T* orow = out + (static_cast<long long>(b) * S + row) * H * D +
              static_cast<long long>(h) * D;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      const int d = c0 + n * 8 + gc;
      if (d < D) orow[d] = ptt::from_f32<T>(acc[n][2 * x]);
      if (d + 1 < D) orow[d + 1] = ptt::from_f32<T>(acc[n][2 * x + 1]);
    }
  }
}

// K2a's streamed tile: queries q0 .. q0 + NQ of q and g, with their lse
// and r, into ring slot `buf` (helpers, not lambdas: a lambda that ptxas
// did not inline spilled its captures at the call)
template <typename T, int NQ, int DP, int RS, int NTH>
__device__ __forceinline__ void stage_queries(T* Qs, T* Gs, float* Ls,
                                              float* Rs, const T* qb,
                                              const T* gb, const float* lb,
                                              const float* rb, long long qss,
                                              long long gss, int q0, int buf,
                                              int Sq, int D, int vec) {
  stage_tc<T, NQ, DP, RS, NTH>(Qs + buf * NQ * RS, qb, qss, q0, Sq, D, vec & 1);
  stage_tc<T, NQ, DP, RS, NTH>(Gs + buf * NQ * RS, gb, gss, q0, Sq, D, vec & 8);
  for (int i = threadIdx.x; i < NQ; i += NTH) {
    const bool ok = q0 + i < Sq;
    cp_async4(Ls + buf * NQ + i, ok ? lb + q0 + i : lb, ok);
    cp_async4(Rs + buf * NQ + i, ok ? rb + q0 + i : rb, ok);
  }
}

// K2b's streamed tile `it`: keys it * NK .. (it + 1) * NK of k and v into
// ring slot it & 1
template <typename T, int NK, int DP, int RS>
__device__ __forceinline__ void stage_keys(T* Ks, T* Vs, const T* kb,
                                           const T* vb, long long kss,
                                           long long vss, int it, int Sk,
                                           int D, int vec) {
  const int buf = it & 1;
  stage_tc<T, NK, DP, RS>(Ks + buf * NK * RS, kb, kss, it * NK, Sk, D, vec & 2);
  stage_tc<T, NK, DP, RS>(Vs + buf * NK * RS, vb, vss, it * NK, Sk, D, vec & 4);
}

// Shared memory of K2a: K and V [64][RS] resident, Q and G [2][NQ][RS]
// streamed, lse and r [2][NQ] f32, and the D split's exchange.
template <typename T, int RS, int NQ, int DS>
constexpr size_t dkdv_smem_bytes() {
  return sizeof(T) * (2 * kTcM + 4 * NQ) * RS + sizeof(float) * 4 * NQ +
         (DS > 1 ? sizeof(float) * DS * kTcWarps * 2 * NQ * 4 * 4 : 0);
}

// Shared memory of K2b: Q and G [64][RS] resident, K and V [2][NK][RS].
template <typename T, int RS, int NK>
constexpr size_t dq_smem_bytes() {
  return sizeof(T) * (2 * kTcM + 4 * NK) * RS;
}

// ------------------------------------- bf16 / f16: 16-bit tensor cores
// K2a.  NQ: queries per streamed tile; DS: warps per 16-key group.  vec:
// bit i set when tensor i of (q, k, v, g) takes 16-byte copies.
template <typename T, int DP, int NQ, int DS>
__global__ void __launch_bounds__(kTcThreads * DS)
flash_bwd_dkdv_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ g,
                         const float* __restrict__ lse,
                         const float* __restrict__ rc, T* __restrict__ dk,
                         T* __restrict__ dv, int H, int Sq, int Sk, int D,
                         Ptrs qs, Ptrs ks, Ptrs vs, Ptrs gs, float scale,
                         int causal, int vec) {
  constexpr int NTH = kTcThreads * DS;
  constexpr int RS = DP + 8;
  constexpr int NT = NQ / 8;            // 8-query column tiles of S^T
  constexpr int DW = DP / DS;           // head dims of dk / dv per warp
  constexpr int DT = DW / 8;            // 8-wide column tiles of them
  constexpr int KK = DW / 16;           // 16-deep steps of S^T / dP^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + kTcM * RS;
  T* Qs = Vs + kTcM * RS;               // [2][NQ][RS]
  T* Gs = Qs + 2 * NQ * RS;             // [2][NQ][RS]
  float* Ls = reinterpret_cast<float*>(Gs + 2 * NQ * RS);   // [2][NQ]
  float* Rs = Ls + 2 * NQ;              // [2][NQ]
  float* Xs = Rs + 2 * NQ;              // the D split's exchange

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rg = warp % kTcWarps;       // 16-key group
  const int dh = warp / kTcWarps;       // which DW columns of dk / dv
  const int gr = lane / 4;              // accumulator row in the warp's 16
  const int gc = 2 * (lane % 4);        // accumulator column in an 8-tile
  const int lm = lane / 8;              // ldmatrix: which 8x8 matrix
  const int lr = lane % 8;              // ldmatrix: which row of it
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  // key tile 0 sees the most queries: it goes out first
  const int k0 = static_cast<int>(blockIdx.y) * kTcM;
  const int offset = Sk - Sq;

  const T* qb = q + b * qs.sb + h * qs.sh;
  const T* kb = k + b * ks.sb + h * ks.sh;
  const T* vb = v + b * vs.sb + h * vs.sh;
  const T* gb = g + b * gs.sb + h * gs.sh;
  const float* lb = lse + static_cast<long long>(bh) * Sq;
  const float* rb = rc + static_cast<long long>(bh) * Sq;

  // causal: query i sees this tile's first key k0 once i >= k0 - offset
  const int qstart = causal ? (max(0, k0 - offset) / NQ) * NQ : 0;
  const int ntiles = (Sq - qstart + NQ - 1) / NQ;

  stage_tc<T, kTcM, DP, RS, NTH>(Ks, kb, ks.ss, k0, Sk, D, vec & 2);
  stage_tc<T, kTcM, DP, RS, NTH>(Vs, vb, vs.ss, k0, Sk, D, vec & 4);
  stage_queries<T, NQ, DP, RS, NTH>(Qs, Gs, Ls, Rs, qb, gb, lb, rb, qs.ss,
                                     gs.ss, qstart, 0, Sq, D, vec);
  cp_async_commit();

  float dk_acc[DT][4], dv_acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  // this lane's ldmatrix rows: A over the group's 16 keys, B over 16
  // queries, from the first head dim of this warp's reduction
  const int kbase = dh * DW;
  const T* ka = Ks + (rg * 16 + (lm & 1) * 8 + lr) * RS + (lm >> 1) * 8 + kbase;
  const T* va = Vs + (rg * 16 + (lm & 1) * 8 + lr) * RS + (lm >> 1) * 8 + kbase;
  const int b_off = ((lm >> 1) * 8 + lr) * RS + (lm & 1) * 8 + kbase;  // [n][k]
  const int bt_off = ((lm & 1) * 8 + lr) * RS + (lm >> 1) * 8 + kbase;  // [k][n]
  const int kj0 = k0 + rg * 16 + gr;    // this lane's two keys: kj0, kj0 + 8

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) {
      stage_queries<T, NQ, DP, RS, NTH>(
          Qs, Gs, Ls, Rs, qb, gb, lb, rb, qs.ss, gs.ss,
          qstart + (it + 1) * NQ, (it + 1) & 1, Sq, D, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = qstart + it * NQ;
    const T* Qc = Qs + (it & 1) * NQ * RS;
    const T* Gc = Gs + (it & 1) * NQ * RS;

    // S^T = K.Q^T and dP^T = V.G^T over the group's 16 keys x NQ queries
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      uint32_t ak[4], av[4];
      ldsm_x4(ak, ka + kk * 16);
      ldsm_x4(av, va + kk * 16);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bq[4], bg[4];
        ldsm_x4(bq, Qc + np * 16 * RS + kk * 16 + b_off);
        ldsm_x4(bg, Gc + np * 16 * RS + kk * 16 + b_off);
        mma16816<T>(s[2 * np], ak, bq[0], bq[1]);
        mma16816<T>(s[2 * np + 1], ak, bq[2], bq[3]);
        mma16816<T>(dp[2 * np], av, bg[0], bg[1]);
        mma16816<T>(dp[2 * np + 1], av, bg[2], bg[3]);
      }
    }
    if constexpr (DS > 1) add_partner<NT>(s, dp, Xs, warp, lane);

    const bool full = !(causal && k0 + kTcM - 1 > q0 + offset) &&
                      q0 + NQ <= Sq && k0 + kTcM <= Sk;
    dkdv_probs<NT>(s, dp, Ls + (it & 1) * NQ, Rs + (it & 1) * NQ, q0, kj0,
                   gc, full, Sq, Sk, offset, causal, scale);

    // dV += P^T.G and dK += dS^T.Q over this warp's DW head dims,
    // P^T / dS^T rounded to T straight from registers
#pragma unroll
    for (int kq = 0; kq < NQ / 16; ++kq) {
      uint32_t ap[4], ads[4];
      acc_to_a<T>(ap, s[2 * kq], s[2 * kq + 1]);
      acc_to_a<T>(ads, dp[2 * kq], dp[2 * kq + 1]);
#pragma unroll
      for (int np = 0; np < DW / 16; ++np) {
        uint32_t bg[4], bq[4];
        ldsm_x4_t(bg, Gc + kq * 16 * RS + np * 16 + bt_off);
        ldsm_x4_t(bq, Qc + kq * 16 * RS + np * 16 + bt_off);
        mma16816<T>(dv_acc[2 * np], ap, bg[0], bg[1]);
        mma16816<T>(dv_acc[2 * np + 1], ap, bg[2], bg[3]);
        mma16816<T>(dk_acc[2 * np], ads, bq[0], bq[1]);
        mma16816<T>(dk_acc[2 * np + 1], ads, bq[2], bq[3]);
      }
    }
    __syncthreads();                    // this buffer is free to refill
  }

  store_rows<T, DT>(dk, dk_acc, b, h, H, Sk, D, kj0, dh * DW, gc);
  store_rows<T, DT>(dv, dv_acc, b, h, H, Sk, D, kj0, dh * DW, gc);
}

// K2b.  NK: keys per streamed tile.
template <typename T, int DP, int NK>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dq_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ g,
                       const float* __restrict__ lse,
                       const float* __restrict__ rc, T* __restrict__ dq,
                       int H, int Sq, int Sk, int D, Ptrs qs, Ptrs ks,
                       Ptrs vs, Ptrs gs, float scale, int causal, int vec) {
  constexpr int RS = DP + 8;
  constexpr int NT = NK / 8;            // 8-key column tiles of S
  constexpr int DT = DP / 8;            // 8-wide column tiles of dq
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Gs = Qs + kTcM * RS;
  T* Ks = Gs + kTcM * RS;               // [2][NK][RS]
  T* Vs = Ks + 2 * NK * RS;             // [2][NK][RS]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gr = lane / 4;
  const int gc = 2 * (lane % 4);
  const int lm = lane / 8;
  const int lr = lane % 8;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  // the last query tile sees the most keys: it goes out first
  const int q0 =
      ((Sq + kTcM - 1) / kTcM - 1 - static_cast<int>(blockIdx.y)) * kTcM;
  const int offset = Sk - Sq;

  const T* qb = q + b * qs.sb + h * qs.sh;
  const T* kb = k + b * ks.sb + h * ks.sh;
  const T* vb = v + b * vs.sb + h * vs.sh;
  const T* gb = g + b * gs.sb + h * gs.sh;

  // causal: the tile's last valid query sees keys up to q_last + offset
  const int kend = causal ? min(Sk, min(q0 + kTcM, Sq) + offset) : Sk;
  const int ntiles = (kend + NK - 1) / NK;

  stage_tc<T, kTcM, DP>(Qs, qb, qs.ss, q0, Sq, D, vec & 1);
  stage_tc<T, kTcM, DP>(Gs, gb, gs.ss, q0, Sq, D, vec & 8);
  stage_keys<T, NK, DP, RS>(Ks, Vs, kb, vb, ks.ss, vs.ss, 0, Sk, D, vec);
  cp_async_commit();

  // this lane's two query rows
  const int qi0 = q0 + warp * 16 + gr;
  float lrow[2], rrow[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int qi = qi0 + x * 8;
    const long long o = static_cast<long long>(bh) * Sq + qi;
    lrow[x] = qi < Sq ? lse[o] * kLog2e : 0.f;
    rrow[x] = qi < Sq ? rc[o] : 0.f;
  }

  float dq_acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[n][e] = 0.f;

  const T* qa = Qs + (warp * 16 + (lm & 1) * 8 + lr) * RS + (lm >> 1) * 8;
  const T* ga = Gs + (warp * 16 + (lm & 1) * 8 + lr) * RS + (lm >> 1) * 8;
  const int b_off = ((lm >> 1) * 8 + lr) * RS + (lm & 1) * 8;   // [n][k]
  const int bt_off = ((lm & 1) * 8 + lr) * RS + (lm >> 1) * 8;  // [k][n]

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) {
      stage_keys<T, NK, DP, RS>(Ks, Vs, kb, vb, ks.ss, vs.ss, it + 1, Sk, D,
                                vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = it * NK;
    const T* Kc = Ks + (it & 1) * NK * RS;
    const T* Vc = Vs + (it & 1) * NK * RS;

    // S = Q.K^T and dP = G.V^T over the warp's 16 queries x NK keys
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t aq[4], ag[4];
      ldsm_x4(aq, qa + kk * 16);
      ldsm_x4(ag, ga + kk * 16);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bk[4], bv[4];
        ldsm_x4(bk, Kc + np * 16 * RS + kk * 16 + b_off);
        ldsm_x4(bv, Vc + np * 16 * RS + kk * 16 + b_off);
        mma16816<T>(s[2 * np], aq, bk[0], bk[1]);
        mma16816<T>(s[2 * np + 1], aq, bk[2], bk[3]);
        mma16816<T>(dp[2 * np], ag, bv[0], bv[1]);
        mma16816<T>(dp[2 * np + 1], ag, bv[2], bv[3]);
      }
    }

    const bool full = !(causal && k0 + NK - 1 > q0 + offset) &&
                      q0 + kTcM <= Sq && k0 + NK <= Sk;
    dq_scores<NT>(s, dp, lrow, rrow, qi0, k0, gc, full, Sq, Sk, offset,
                  causal, scale);

    // dQ += dS.K, dS straight from registers, K by ldmatrix.trans
#pragma unroll
    for (int kq = 0; kq < NK / 16; ++kq) {
      uint32_t ads[4];
      acc_to_a<T>(ads, dp[2 * kq], dp[2 * kq + 1]);
#pragma unroll
      for (int np = 0; np < DP / 16; ++np) {
        uint32_t bk[4];
        ldsm_x4_t(bk, Kc + kq * 16 * RS + np * 16 + bt_off);
        mma16816<T>(dq_acc[2 * np], ads, bk[0], bk[1]);
        mma16816<T>(dq_acc[2 * np + 1], ads, bk[2], bk[3]);
      }
    }
    __syncthreads();                    // this buffer is free to refill
  }

  store_rows<T, DT>(dq, dq_acc, b, h, H, Sq, D, qi0, 0, gc);
}

// ------------------------------------------- f32: 3xTF32 tensor cores
// K2a, the 16-bit K2a's structure with TF32 fragments from plain shared
// loads (rows DP + 4 floats; see the header for the two k orders).
template <int DP, int NQ, int DS>
__global__ void __launch_bounds__(kTcThreads * DS)
flash_bwd_dkdv_f32_tc_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ g,
                             const float* __restrict__ lse,
                             const float* __restrict__ rc,
                             float* __restrict__ dk, float* __restrict__ dv,
                             int H, int Sq, int Sk, int D, Ptrs qs, Ptrs ks,
                             Ptrs vs, Ptrs gs, float scale, int causal,
                             int vec) {
  constexpr int NTH = kTcThreads * DS;
  constexpr int RS = DP + 4;
  constexpr int NT = NQ / 8;            // 8-query tiles of S^T (k steps of
                                        // the second products)
  constexpr int DW = DP / DS;           // head dims of dk / dv per warp
  constexpr int DT = DW / 8;
  constexpr int KK = DW / 8;            // 8-deep steps of S^T / dP^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);    // [64][RS]
  float* Vs = Ks + kTcM * RS;                        // [64][RS]
  float* Qs = Vs + kTcM * RS;                        // [2][NQ][RS]
  float* Gs = Qs + 2 * NQ * RS;                      // [2][NQ][RS]
  float* Ls = Gs + 2 * NQ * RS;                      // [2][NQ]
  float* Rs = Ls + 2 * NQ;                           // [2][NQ]
  float* Xs = Rs + 2 * NQ;                           // the D split's exchange

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rg = warp % kTcWarps;
  const int dh = warp / kTcWarps;
  const int gq = lane / 4;              // fragment row (and B column)
  const int t = lane % 4;               // fragment column
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = static_cast<int>(blockIdx.y) * kTcM;
  const int offset = Sk - Sq;

  const float* qb = q + b * qs.sb + h * qs.sh;
  const float* kb = k + b * ks.sb + h * ks.sh;
  const float* vb = v + b * vs.sb + h * vs.sh;
  const float* gb = g + b * gs.sb + h * gs.sh;
  const float* lb = lse + static_cast<long long>(bh) * Sq;
  const float* rb = rc + static_cast<long long>(bh) * Sq;

  const int qstart = causal ? (max(0, k0 - offset) / NQ) * NQ : 0;
  const int ntiles = (Sq - qstart + NQ - 1) / NQ;

  stage_tc<float, kTcM, DP, RS, NTH>(Ks, kb, ks.ss, k0, Sk, D, vec & 2);
  stage_tc<float, kTcM, DP, RS, NTH>(Vs, vb, vs.ss, k0, Sk, D, vec & 4);
  stage_queries<float, NQ, DP, RS, NTH>(Qs, Gs, Ls, Rs, qb, gb, lb, rb,
                                        qs.ss, gs.ss, qstart, 0, Sq, D, vec);
  cp_async_commit();

  float dk_acc[DT][4], dv_acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  // A rows of the first products: keys gq and gq + 8 of the group, from
  // the first head dim of this warp's reduction
  const int kbase = dh * DW;
  const float* kr = Ks + (rg * 16 + gq) * RS + kbase + t;
  const float* vr = Vs + (rg * 16 + gq) * RS + kbase + t;
  const int kj0 = k0 + rg * 16 + gq;

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) {
      stage_queries<float, NQ, DP, RS, NTH>(
          Qs, Gs, Ls, Rs, qb, gb, lb, rb, qs.ss, gs.ss,
          qstart + (it + 1) * NQ, (it + 1) & 1, Sq, D, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = qstart + it * NQ;
    const float* Qc = Qs + (it & 1) * NQ * RS;
    const float* Gc = Gs + (it & 1) * NQ * RS;

    // S^T = K.Q^T and dP^T = V.G^T, head_dim in its natural order: A
    // (keys gq, gq + 8; dims t, t + 4), B (query 8 n + gq; dims t, t + 4)
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      const float* kx = kr + kk * 8;
      const float* vx = vr + kk * 8;
      const Tf32Frag ak = split_frag(kx[0], kx[8 * RS], kx[4], kx[8 * RS + 4]);
      const Tf32Frag av = split_frag(vx[0], vx[8 * RS], vx[4], vx[8 * RS + 4]);
      const float* qn = Qc + gq * RS + kbase + kk * 8 + t;
      const float* gn = Gc + gq * RS + kbase + kk * 8 + t;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        mma1688_3xtf32(s[n], ak, qn[n * 8 * RS], qn[n * 8 * RS + 4]);
        mma1688_3xtf32(dp[n], av, gn[n * 8 * RS], gn[n * 8 * RS + 4]);
      }
    }
    if constexpr (DS > 1) add_partner<NT>(s, dp, Xs, warp, lane);

    const bool full = !(causal && k0 + kTcM - 1 > q0 + offset) &&
                      q0 + NQ <= Sq && k0 + kTcM <= Sk;
    dkdv_probs<NT>(s, dp, Ls + (it & 1) * NQ, Rs + (it & 1) * NQ, q0, kj0,
                   2 * t, full, Sq, Sk, offset, causal, scale);

    // dV += P^T.G and dK += dS^T.Q over this warp's DW head dims; k step
    // kq takes queries 8 kq + (0, 2, 4, 6, 1, 3, 5, 7), so the P^T / dS^T
    // accumulators are the A fragments as they stand, and B is rows
    // 8 kq + 2t and + 1 at column 8 n + gq
#pragma unroll
    for (int kq = 0; kq < NT; ++kq) {
      const Tf32Frag ap = split_frag(s[kq][0], s[kq][2], s[kq][1], s[kq][3]);
      const Tf32Frag ads =
          split_frag(dp[kq][0], dp[kq][2], dp[kq][1], dp[kq][3]);
      const float* gx = Gc + (kq * 8 + 2 * t) * RS + kbase + gq;
      const float* qx = Qc + (kq * 8 + 2 * t) * RS + kbase + gq;
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        mma1688_3xtf32(dv_acc[n], ap, gx[n * 8], gx[RS + n * 8]);
        mma1688_3xtf32(dk_acc[n], ads, qx[n * 8], qx[RS + n * 8]);
      }
    }
    __syncthreads();                    // this buffer is free to refill
  }

  store_rows<float, DT>(dk, dk_acc, b, h, H, Sk, D, kj0, dh * DW, 2 * t);
  store_rows<float, DT>(dv, dv_acc, b, h, H, Sk, D, kj0, dh * DW, 2 * t);
}

// K2b, the 16-bit K2b's structure with TF32 fragments.
template <int DP, int NK>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dq_f32_tc_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ g,
                           const float* __restrict__ lse,
                           const float* __restrict__ rc,
                           float* __restrict__ dq, int H, int Sq, int Sk,
                           int D, Ptrs qs, Ptrs ks, Ptrs vs, Ptrs gs,
                           float scale, int causal, int vec) {
  constexpr int RS = DP + 4;
  constexpr int NT = NK / 8;            // 8-key tiles of S (k steps of dQ)
  constexpr int DT = DP / 8;            // 8-wide tiles of dq (k steps of S)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);    // [64][RS]
  float* Gs = Qs + kTcM * RS;                        // [64][RS]
  float* Ks = Gs + kTcM * RS;                        // [2][NK][RS]
  float* Vs = Ks + 2 * NK * RS;                      // [2][NK][RS]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gq = lane / 4;
  const int t = lane % 4;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 =
      ((Sq + kTcM - 1) / kTcM - 1 - static_cast<int>(blockIdx.y)) * kTcM;
  const int offset = Sk - Sq;

  const float* qb = q + b * qs.sb + h * qs.sh;
  const float* kb = k + b * ks.sb + h * ks.sh;
  const float* vb = v + b * vs.sb + h * vs.sh;
  const float* gb = g + b * gs.sb + h * gs.sh;

  const int kend = causal ? min(Sk, min(q0 + kTcM, Sq) + offset) : Sk;
  const int ntiles = (kend + NK - 1) / NK;

  stage_tc<float, kTcM, DP, RS>(Qs, qb, qs.ss, q0, Sq, D, vec & 1);
  stage_tc<float, kTcM, DP, RS>(Gs, gb, gs.ss, q0, Sq, D, vec & 8);
  stage_keys<float, NK, DP, RS>(Ks, Vs, kb, vb, ks.ss, vs.ss, 0, Sk, D,
                                vec);
  cp_async_commit();

  const int qi0 = q0 + warp * 16 + gq;
  float lrow[2], rrow[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int qi = qi0 + x * 8;
    const long long o = static_cast<long long>(bh) * Sq + qi;
    lrow[x] = qi < Sq ? lse[o] * kLog2e : 0.f;
    rrow[x] = qi < Sq ? rc[o] : 0.f;
  }

  float dq_acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[n][e] = 0.f;

  const float* qr = Qs + (warp * 16 + gq) * RS + t;
  const float* gr = Gs + (warp * 16 + gq) * RS + t;

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) {
      stage_keys<float, NK, DP, RS>(Ks, Vs, kb, vb, ks.ss, vs.ss, it + 1,
                                    Sk, D, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = it * NK;
    const float* Kc = Ks + (it & 1) * NK * RS;
    const float* Vc = Vs + (it & 1) * NK * RS;

    // S = Q.K^T and dP = G.V^T, head_dim in its natural order
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DT; ++kk) {
      const float* qx = qr + kk * 8;
      const float* gx = gr + kk * 8;
      const Tf32Frag aq = split_frag(qx[0], qx[8 * RS], qx[4], qx[8 * RS + 4]);
      const Tf32Frag ag = split_frag(gx[0], gx[8 * RS], gx[4], gx[8 * RS + 4]);
      const float* kn = Kc + gq * RS + kk * 8 + t;
      const float* vn = Vc + gq * RS + kk * 8 + t;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        mma1688_3xtf32(s[n], aq, kn[n * 8 * RS], kn[n * 8 * RS + 4]);
        mma1688_3xtf32(dp[n], ag, vn[n * 8 * RS], vn[n * 8 * RS + 4]);
      }
    }

    const bool full = !(causal && k0 + NK - 1 > q0 + offset) &&
                      q0 + kTcM <= Sq && k0 + NK <= Sk;
    dq_scores<NT>(s, dp, lrow, rrow, qi0, k0, 2 * t, full, Sq, Sk, offset,
                  causal, scale);

    // dQ += dS.K; k step kq takes keys 8 kq + (0, 2, 4, 6, 1, 3, 5, 7):
    // dS is the A fragment as it stands, B is K rows 8 kq + 2t and + 1
#pragma unroll
    for (int kq = 0; kq < NT; ++kq) {
      const Tf32Frag ads =
          split_frag(dp[kq][0], dp[kq][2], dp[kq][1], dp[kq][3]);
      const float* kx = Kc + (kq * 8 + 2 * t) * RS + gq;
#pragma unroll
      for (int n = 0; n < DT; ++n)
        mma1688_3xtf32(dq_acc[n], ads, kx[n * 8], kx[RS + n * 8]);
    }
    __syncthreads();                    // this buffer is free to refill
  }

  store_rows<float, DT>(dq, dq_acc, b, h, H, Sq, D, qi0, 0, 2 * t);
}

// ------------------------------------------------------------- launches
Ptrs ptrs(const long long* st, int which) {
  return Ptrs{st[3 * which], st[3 * which + 1], st[3 * which + 2]};
}

// One kernel launch on (batch * head, 64-row tile): shared memory opted
// into, 16-byte staging per tensor, the launch's own error.
template <typename T, typename Kernel, typename... Out>
cudaError_t launch(Kernel kernel, int threads, size_t smem, const void* q,
                   const void* k, const void* v, const void* g,
                   const float* lse, const float* r, int B, int H, int Sq,
                   int Sk, int D, int rows, const long long* st, float scale,
                   int causal, cudaStream_t stream, Out*... out) {
  cudaError_t err = ptt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const void* x[4] = {q, k, v, g};
  const int vec = vec_mask(x, 4, st, D, sizeof(T));
  dim3 grid(B * H, (rows + kTcM - 1) / kTcM);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g), lse, r,
      static_cast<T*>(out)..., H, Sq, Sk, D, ptrs(st, 0), ptrs(st, 1),
      ptrs(st, 2), ptrs(st, 3), scale, causal, vec);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_dkdv(const void* q, const void* k, const void* v,
                        const void* g, const float* lse, const float* r,
                        void* dk, void* dv, int B, int H, int Sq, int Sk,
                        int D, const long long* st, float scale, int causal,
                        cudaStream_t s) {
  constexpr bool F32 = std::is_same<T, float>::value;
  using C = Tiles<F32, DP>;
  constexpr int RS = F32 ? DP + 4 : DP + 8;
  constexpr size_t smem =
      dkdv_smem_bytes<T, RS, C::NQ, C::DS>();
  if constexpr (F32)
    return launch<T>(flash_bwd_dkdv_f32_tc_kernel<DP, C::NQ, C::DS>,
                     kTcThreads * C::DS, smem, q, k, v, g, lse, r, B, H, Sq,
                     Sk, D, Sk, st, scale, causal, s, dk, dv);
  else
    return launch<T>(flash_bwd_dkdv_tc_kernel<T, DP, C::NQ, C::DS>,
                     kTcThreads * C::DS, smem, q, k, v, g, lse, r, B, H, Sq,
                     Sk, D, Sk, st, scale, causal, s, dk, dv);
}

template <typename T, int DP>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* g, const float* lse, const float* r,
                      void* dq, int B, int H, int Sq, int Sk, int D,
                      const long long* st, float scale, int causal,
                      cudaStream_t s) {
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int NK = Tiles<F32, DP>::NK;
  constexpr int RS = F32 ? DP + 4 : DP + 8;
  constexpr size_t smem = dq_smem_bytes<T, RS, NK>();
  if constexpr (F32)
    return launch<T>(flash_bwd_dq_f32_tc_kernel<DP, NK>, kTcThreads, smem, q,
                     k, v, g, lse, r, B, H, Sq, Sk, D, Sq, st, scale, causal,
                     s, dq);
  else
    return launch<T>(flash_bwd_dq_tc_kernel<T, DP, NK>, kTcThreads, smem, q,
                     k, v, g, lse, r, B, H, Sq, Sk, D, Sq, st, scale, causal,
                     s, dq);
}

bool bad_shape(int B, int H, int Sq, int Sk, int D) {
  return D < 1 || D > 256 || B < 1 || H < 1 || Sq < 1 || Sk < 1;
}

// The body that takes a call: every head_dim (padded to 64, 128 or 256)
// runs on the tensor cores, bf16 / f16 by 16-bit products, f32 by 3xTF32
// (the forward's names and numbers, csrc/flash_attention_fwd.cu FwdBody).
// The wrapper counts launches by it.
enum BwdBody : int { kBwdTc16 = 1, kBwd3xTf32 = 2 };

int bwd_body(int dtype) {
  return dtype == ptt::kF32 ? kBwd3xTf32 : kBwdTc16;
}

}  // namespace

namespace ptt {
namespace fa_bwd {

// T is the C++ type of the inputs' dtype; head_dim D is padded to DP =
// 64, 128 or 256.
template <typename T>
cudaError_t run_dkdv(const void* q, const void* k, const void* v,
                     const void* g, const float* l, const float* rr, void* dk,
                     void* dv, int B, int H, int Sq, int Sk, int D,
                     const long long* strides, float scale, int causal,
                     cudaStream_t s) {
  return D <= 64 ? launch_dkdv<T, 64>(q, k, v, g, l, rr, dk, dv, B, H, Sq, Sk,
                                      D, strides, scale, causal, s)
       : D <= 128 ? launch_dkdv<T, 128>(q, k, v, g, l, rr, dk, dv, B, H, Sq,
                                        Sk, D, strides, scale, causal, s)
                  : launch_dkdv<T, 256>(q, k, v, g, l, rr, dk, dv, B, H, Sq,
                                        Sk, D, strides, scale, causal, s);
}

template <typename T>
cudaError_t run_dq(const void* q, const void* k, const void* v,
                   const void* g, const float* l, const float* rr, void* dq,
                   int B, int H, int Sq, int Sk, int D,
                   const long long* strides, float scale, int causal,
                   cudaStream_t s) {
  return D <= 64 ? launch_dq<T, 64>(q, k, v, g, l, rr, dq, B, H, Sq, Sk, D,
                                    strides, scale, causal, s)
       : D <= 128 ? launch_dq<T, 128>(q, k, v, g, l, rr, dq, B, H, Sq, Sk, D,
                                      strides, scale, causal, s)
                  : launch_dq<T, 256>(q, k, v, g, l, rr, dq, B, H, Sq, Sk, D,
                                      strides, scale, causal, s);
}

}  // namespace fa_bwd
}  // namespace ptt

// Built in three parts (ops/_build.py): part p instantiates the dtype of
// code p (common.cuh DType); part 0 also holds the entries.
#define PTT_FA_BWD_RUN(EXTERN, T)                                            \
  EXTERN template cudaError_t ptt::fa_bwd::run_dkdv<T>(                      \
      const void*, const void*, const void*, const void*, const float*,      \
      const float*, void*, void*, int, int, int, int, int, const long long*, \
      float, int, cudaStream_t);                                             \
  EXTERN template cudaError_t ptt::fa_bwd::run_dq<T>(                        \
      const void*, const void*, const void*, const void*, const float*,      \
      const float*, void*, int, int, int, int, int, const long long*, float, \
      int, cudaStream_t);
#if PTT_PART == 0
PTT_FA_BWD_RUN(, float)
#elif PTT_PART > 0
PTT_FA_BWD_RUN(extern, float)
#endif
#if PTT_PART == 1
PTT_FA_BWD_RUN(, __half)
#elif PTT_PART >= 0
PTT_FA_BWD_RUN(extern, __half)
#endif
#if PTT_PART == 2
PTT_FA_BWD_RUN(, __nv_bfloat16)
#elif PTT_PART >= 0
PTT_FA_BWD_RUN(extern, __nv_bfloat16)
#endif

#if PTT_PART <= 0

// q/g: [B, Sq, H, D], k/v: [B, Sk, H, D], with element strides (batch,
// seq, head) in `strides` (q, k, v, g in that order; the head dim is
// unit-stride).  lse, r: [B * H, Sq] f32.  dk, dv: contiguous
// [B, Sk, H, D] in the input dtype.  Returns the launch's cudaError_t.
extern "C" int ptt_flash_attention_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* g,
    const void* lse, const void* r, void* dk, void* dv, int dtype, int B,
    int H, int Sq, int Sk, int D, const long long* strides, float scale,
    int causal, void* stream) {
  if (bad_shape(B, H, Sq, Sk, D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* rr = static_cast<const float*>(r);
  cudaError_t err = cudaSuccess;
  PTT_DISPATCH_DTYPE(dtype, {
    err = ptt::fa_bwd::run_dkdv<scalar_t>(q, k, v, g, l, rr, dk, dv, B, H, Sq,
                                          Sk, D, strides, scale, causal, s);
  });
  return static_cast<int>(err);
}

// As above; dq: contiguous [B, Sq, H, D] in the input dtype.
extern "C" int ptt_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* g,
    const void* lse, const void* r, void* dq, int dtype, int B, int H,
    int Sq, int Sk, int D, const long long* strides, float scale, int causal,
    void* stream) {
  if (bad_shape(B, H, Sq, Sk, D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* rr = static_cast<const float*>(r);
  cudaError_t err = cudaSuccess;
  PTT_DISPATCH_DTYPE(dtype, {
    err = ptt::fa_bwd::run_dq<scalar_t>(q, k, v, g, l, rr, dq, B, H, Sq, Sk, D,
                                        strides, scale, causal, s);
  });
  return static_cast<int>(err);
}

// The body both backward entries launch for (dtype, D): 1 the 16-bit
// tensor cores, 2 3xTF32 (the wrapper counts launches per body).
extern "C" int ptt_flash_attention_bwd_body(int dtype, int D) {
  (void)D;
  return bwd_body(dtype);
}
#endif  // PTT_PART <= 0
