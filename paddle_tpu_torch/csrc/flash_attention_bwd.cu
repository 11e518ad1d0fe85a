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
// tensor-core rate.
//
// bf16 / f16 design (the training path's bf16 under AMP O2), after
// FlashAttention-2's backward.  Every product runs on the tensor cores as
// mma.sync.m16n8k16 (16-bit inputs, f32 accumulators) fed by ldmatrix out
// of shared memory.  A block is 4 warps; each warp owns 16 rows of the
// block's resident 64-row tile and sweeps the streamed tiles:
//   K2a: grid (batch * head, 64-key tile).  K and V stay in shared
//        memory; the loop streams the visible query tiles (q, g, lse, r).
//        With keys as the M dimension the warp computes S^T = K.Q^T and
//        dP^T = V.G^T, so the P^T and dS^T accumulator fragments convert
//        to 16-bit in registers and serve directly as the A operand of
//        dV += P^T.G and dK += dS^T.Q (G and Q read by ldmatrix.trans):
//        no score round-trips through shared memory.
//   K2b: grid (batch * head, 64-query tile).  Q, G, and the warp's lse /
//        r rows stay resident; the loop streams 64-key tiles of K and V
//        up to the causal bound.  dS goes from registers into
//        dQ += dS.K, with K read by ldmatrix.trans.
// p and ds are rounded to the input dtype before their second product, as
// PyTorch's flash backward does.  Tiles are staged in the input dtype with
// 16-byte cp.async.cg into a double-buffered ring (the next streamed tile
// loads while the current one is computed); each row is padded by 16
// bytes so ldmatrix's eight row reads hit distinct banks, and head_dim is
// zero-padded to 64 or 128.  Rows that cannot take 16-byte copies (D*2 not
// a multiple of 16, or a misaligned base or stride) are staged by a
// scalar loop inside the same kernel.  q/k/v/g are read in the public
// [B, S, H, D] layout from their strides (unit stride in head_dim), so the
// model's head-major qkv split needs no copy; ragged tiles are zero-filled
// and masked, and the element mask runs only on tiles that the causal
// diagonal or a ragged edge crosses (tiles wholly above the diagonal are
// never visited).  The tile with the most work goes out first: the first
// key tile in K2a, the last query tile in K2b, with batch * head as the
// fast grid axis so each wave takes the heaviest tiles of every head.
// head_dim <= 128.
//
// f32 design, and every dtype at 128 < head_dim <= 256: the exact SIMT
// body (plain f32 FMAs out of shared memory).  f32 callers (the f32
// card-vs-CPU training parity, rtol 1e-4) need full f32 products, which
// one-pass TF32 tensor cores would not give, so f32 stays bounded by the
// 67 TFLOP/s f32 rate.  One block of 256 threads per (KB-row tile, batch *
// head), KB = 64 at head_dim <= 128 and 32 at 129-256 (at 64 rows a
// 256-wide K2a would need 297 KB of shared memory, over the 227 KB a block
// may have); 256 / KB threads own one key (K2a) or query (K2b) row and
// accumulate DP * KB / 256 output columns in registers; tiles are staged
// as f32 with a +1 row pad (K2a 100 / 166 / 137 KB and K2b 83 / 149 / 133
// KB of shared memory at head_dim 64 / 128 / 256, opted in per launch).
// No model of the repository trains above head_dim 128, so the 256-wide
// body is the simple one; bf16 / f16 at head_dim <= 128 keep the tensor
// cores.
#include "common.cuh"
#include "mma.cuh"

#include <math.h>
#include <type_traits>

namespace {

using namespace ptt::tc;

struct Ptrs {
  long long sb, ss, sh;                 // element strides: batch, seq, head
};

// ------------------------------------------------------- f32: SIMT body
constexpr int kThreads = 256;

// KB rows (queries or keys) per tile: 64 at head_dim <= 128, 32 above
template <int KB>
struct Simt {
  static constexpr int kTPR = kThreads / KB;   // threads per owned row
  static constexpr int kCols = KB / kTPR;      // scores per thread per tile
  static constexpr int kPS = KB + 1;           // padded row of a [KB][KB] tile
};

template <int DP, int KB>
constexpr size_t dkdv_smem_bytes() {
  // K, V, Q, G [KB][DP+1]; P^T, dS^T [KB][KB+1]; lse, r [KB]
  return sizeof(float) * (4 * KB * (DP + 1) + 2 * KB * (KB + 1) + 2 * KB);
}

template <int DP, int KB>
constexpr size_t dq_smem_bytes() {
  // Q, G, K, V [KB][DP+1]; dS [KB][KB+1]
  return sizeof(float) * (4 * KB * (DP + 1) + KB * (KB + 1));
}

// Stage rows [row0, row0 + KB) of one (batch, head) slice as f32 into a
// [KB][DP+1] tile; rows past n and columns past D are zero.
template <typename T, int DP, int KB>
__device__ __forceinline__ void stage(float* dst, const T* src, long long ss,
                                      int row0, int n, int D) {
  for (int idx = threadIdx.x; idx < KB * DP; idx += kThreads) {
    const int rr = idx / DP;
    const int d = idx % DP;
    const int row = row0 + rr;
    dst[rr * (DP + 1) + d] =
        (row < n && d < D) ? ptt::to_f32(src[row * ss + d]) : 0.f;
  }
}

template <typename T, int DP, int KB>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ g,
                      const float* __restrict__ lse,
                      const float* __restrict__ rc, T* __restrict__ dk,
                      T* __restrict__ dv, int H, int Sq, int Sk, int D,
                      Ptrs qs, Ptrs ks, Ptrs vs, Ptrs gs, float scale,
                      int causal) {
  constexpr int kTPR = Simt<KB>::kTPR;
  constexpr int kCols = Simt<KB>::kCols;
  constexpr int kPS = Simt<KB>::kPS;
  constexpr int RS = DP + 1;
  constexpr int DPT = DP / kTPR;        // dk / dv columns per thread
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + KB * RS;
  float* Qs = Vs + KB * RS;
  float* Gs = Qs + KB * RS;
  float* Pt = Gs + KB * RS;             // p^T  [key][query]
  float* Dt = Pt + KB * kPS;            // ds^T [key][query]
  float* Ls = Dt + KB * kPS;
  float* Rs = Ls + KB;

  const int tid = threadIdx.x;
  const int j = tid / kTPR;             // this thread's key row in the tile
  const int sub = tid % kTPR;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = blockIdx.x * KB;
  const int kj = k0 + j;
  const int offset = Sk - Sq;

  const T* qb = q + b * qs.sb + h * qs.sh;
  const T* kb = k + b * ks.sb + h * ks.sh;
  const T* vb = v + b * vs.sb + h * vs.sh;
  const T* gb = g + b * gs.sb + h * gs.sh;
  const float* lb = lse + static_cast<long long>(bh) * Sq;
  const float* rb = rc + static_cast<long long>(bh) * Sq;

  stage<T, DP, KB>(Ks, kb, ks.ss, k0, Sk, D);
  stage<T, DP, KB>(Vs, vb, vs.ss, k0, Sk, D);

  float dk_acc[DPT], dv_acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  // causal: query i sees this tile's first key k0 once i >= k0 - offset
  int qstart = 0;
  if (causal) qstart = (max(0, k0 - offset) / KB) * KB;

  const float* krow = Ks + j * RS;
  const float* vrow = Vs + j * RS;
  float* prow = Pt + j * kPS;
  float* drow = Dt + j * kPS;
  for (int q0 = qstart; q0 < Sq; q0 += KB) {
    __syncthreads();                    // K/V staged / last tile consumed
    stage<T, DP, KB>(Qs, qb, qs.ss, q0, Sq, D);
    stage<T, DP, KB>(Gs, gb, gs.ss, q0, Sq, D);
    if (tid < KB) {
      const int row = q0 + tid;
      Ls[tid] = row < Sq ? lb[row] : 0.f;
      Rs[tid] = row < Sq ? rb[row] : 0.f;
    }
    __syncthreads();

    float s[kCols], dp[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) s[c] = dp[c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      const float kd = krow[d];
      const float vd = vrow[d];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int i = sub + c * kTPR;
        s[c] += Qs[i * RS + d] * kd;
        dp[c] += Gs[i * RS + d] * vd;
      }
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int i = sub + c * kTPR;
      const int qi = q0 + i;
      const bool ok = qi < Sq && kj < Sk && (!causal || kj <= qi + offset);
      const float p = ok ? __expf(s[c] * scale - Ls[i]) : 0.f;
      prow[i] = p;
      drow[i] = p * (dp[c] - Rs[i]) * scale;
    }
    __syncwarp();                       // the row's threads share a warp
#pragma unroll 4
    for (int i = 0; i < KB; ++i) {
      const float p = prow[i];
      const float ds = drow[i];
      const float* grow = Gs + i * RS;
      const float* qrow = Qs + i * RS;
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        const int d = sub + c * kTPR;
        dv_acc[c] += p * grow[d];
        dk_acc[c] += ds * qrow[d];
      }
    }
  }

  if (kj < Sk) {
    const long long o = (static_cast<long long>(b) * Sk + kj) * H * D +
                        static_cast<long long>(h) * D;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int d = sub + c * kTPR;
      if (d < D) {
        dk[o + d] = ptt::from_f32<T>(dk_acc[c]);
        dv[o + d] = ptt::from_f32<T>(dv_acc[c]);
      }
    }
  }
}

template <typename T, int DP, int KB>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ g,
                    const float* __restrict__ lse,
                    const float* __restrict__ rc, T* __restrict__ dq, int H,
                    int Sq, int Sk, int D, Ptrs qs, Ptrs ks, Ptrs vs,
                    Ptrs gs, float scale, int causal) {
  constexpr int kTPR = Simt<KB>::kTPR;
  constexpr int kCols = Simt<KB>::kCols;
  constexpr int kPS = Simt<KB>::kPS;
  constexpr int RS = DP + 1;
  constexpr int DPT = DP / kTPR;        // dq columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Gs = Qs + KB * RS;
  float* Ks = Gs + KB * RS;
  float* Vs = Ks + KB * RS;
  float* Ds = Vs + KB * RS;             // ds [query][key]

  const int tid = threadIdx.x;
  const int i = tid / kTPR;             // this thread's query row in the tile
  const int sub = tid % kTPR;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * KB;
  const int qi = q0 + i;
  const int offset = Sk - Sq;

  const T* qb = q + b * qs.sb + h * qs.sh;
  const T* kb = k + b * ks.sb + h * ks.sh;
  const T* vb = v + b * vs.sb + h * vs.sh;
  const T* gb = g + b * gs.sb + h * gs.sh;
  const float l_i = qi < Sq ? lse[static_cast<long long>(bh) * Sq + qi] : 0.f;
  const float r_i = qi < Sq ? rc[static_cast<long long>(bh) * Sq + qi] : 0.f;

  stage<T, DP, KB>(Qs, qb, qs.ss, q0, Sq, D);
  stage<T, DP, KB>(Gs, gb, gs.ss, q0, Sq, D);

  float dq_acc[DPT];
#pragma unroll
  for (int c = 0; c < DPT; ++c) dq_acc[c] = 0.f;

  // causal: the tile's last valid query sees keys up to q_last + offset
  int kend = Sk;
  if (causal) kend = min(Sk, min(q0 + KB, Sq) - 1 + offset + 1);

  const float* qrow = Qs + i * RS;
  const float* grow = Gs + i * RS;
  float* drow = Ds + i * kPS;
  for (int k0 = 0; k0 < kend; k0 += KB) {
    __syncthreads();                    // Q/G staged / last tile consumed
    stage<T, DP, KB>(Ks, kb, ks.ss, k0, Sk, D);
    stage<T, DP, KB>(Vs, vb, vs.ss, k0, Sk, D);
    __syncthreads();

    float s[kCols], dp[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) s[c] = dp[c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      const float qd = qrow[d];
      const float gd = grow[d];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int j = sub + c * kTPR;
        s[c] += qd * Ks[j * RS + d];
        dp[c] += gd * Vs[j * RS + d];
      }
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int j = sub + c * kTPR;
      const int kj = k0 + j;
      const bool ok = qi < Sq && kj < Sk && (!causal || kj <= qi + offset);
      const float p = ok ? __expf(s[c] * scale - l_i) : 0.f;
      drow[j] = p * (dp[c] - r_i) * scale;
    }
    __syncwarp();
#pragma unroll 4
    for (int j = 0; j < KB; ++j) {
      const float ds = drow[j];
      const float* krow = Ks + j * RS;
#pragma unroll
      for (int c = 0; c < DPT; ++c) dq_acc[c] += ds * krow[sub + c * kTPR];
    }
  }

  if (qi < Sq) {
    const long long o = (static_cast<long long>(b) * Sq + qi) * H * D +
                        static_cast<long long>(h) * D;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int d = sub + c * kTPR;
      if (d < D) dq[o + d] = ptt::from_f32<T>(dq_acc[c]);
    }
  }
}

// ------------------------------------- bf16 / f16: tensor-core body
// (mma.sync, ldmatrix and cp.async helpers: mma.cuh)
template <int DP, int NS>
constexpr size_t tc_smem_bytes(size_t elem, int row_vecs) {
  // resident [64][DP+8] x 2, streamed [2][NS][DP+8] x 2, row_vecs f32 [2][NS]
  return elem * (2 * kTcM + 4 * NS) * (DP + 8) + sizeof(float) * row_vecs * 2 * NS;
}

// K2a.  NQ: queries per streamed tile.  vec: bit i set when tensor i of
// (q, k, v, g) takes 16-byte copies.
template <typename T, int DP, int NQ>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dkdv_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ g,
                         const float* __restrict__ lse,
                         const float* __restrict__ rc, T* __restrict__ dk,
                         T* __restrict__ dv, int H, int Sq, int Sk, int D,
                         Ptrs qs, Ptrs ks, Ptrs vs, Ptrs gs, float scale,
                         int causal, int vec) {
  constexpr int RS = DP + 8;
  constexpr int NT = NQ / 8;            // 8-query column tiles of S^T
  constexpr int DT = DP / 8;            // 8-wide column tiles of dk / dv
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + kTcM * RS;
  T* Qs = Vs + kTcM * RS;               // [2][NQ][RS]
  T* Gs = Qs + 2 * NQ * RS;             // [2][NQ][RS]
  float* Ls = reinterpret_cast<float*>(Gs + 2 * NQ * RS);   // [2][NQ]
  float* Rs = Ls + 2 * NQ;              // [2][NQ]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
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

  auto load_tile = [&](int it) {
    const int q0 = qstart + it * NQ;
    const int buf = it & 1;
    stage_tc<T, NQ, DP>(Qs + buf * NQ * RS, qb, qs.ss, q0, Sq, D, vec & 1);
    stage_tc<T, NQ, DP>(Gs + buf * NQ * RS, gb, gs.ss, q0, Sq, D, vec & 8);
    for (int i = threadIdx.x; i < NQ; i += kTcThreads) {
      const bool ok = q0 + i < Sq;
      cp_async4(Ls + buf * NQ + i, ok ? lb + q0 + i : lb, ok);
      cp_async4(Rs + buf * NQ + i, ok ? rb + q0 + i : rb, ok);
    }
  };
  stage_tc<T, kTcM, DP>(Ks, kb, ks.ss, k0, Sk, D, vec & 2);
  stage_tc<T, kTcM, DP>(Vs, vb, vs.ss, k0, Sk, D, vec & 4);
  load_tile(0);
  cp_async_commit();

  float dk_acc[DT][4], dv_acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  // this lane's ldmatrix rows: A over the warp's 16 keys, B over 16 queries
  const T* ka = Ks + (warp * 16 + (lm & 1) * 8 + lr) * RS + (lm >> 1) * 8;
  const T* va = Vs + (warp * 16 + (lm & 1) * 8 + lr) * RS + (lm >> 1) * 8;
  const int b_off = ((lm >> 1) * 8 + lr) * RS + (lm & 1) * 8;   // [n][k]
  const int bt_off = ((lm & 1) * 8 + lr) * RS + (lm >> 1) * 8;  // [k][n]
  const int kj0 = k0 + warp * 16 + gr;  // this lane's two keys: kj0, kj0 + 8

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) {
      load_tile(it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = qstart + it * NQ;
    const T* Qc = Qs + (it & 1) * NQ * RS;
    const T* Gc = Gs + (it & 1) * NQ * RS;
    const float* Lc = Ls + (it & 1) * NQ;
    const float* Rc = Rs + (it & 1) * NQ;

    // S^T = K.Q^T and dP^T = V.G^T over the warp's 16 keys x NQ queries
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
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

    // P^T and dS^T in place; the element mask only where the diagonal or
    // a ragged edge crosses the tile
    const bool full = !(causal && k0 + kTcM - 1 > q0 + offset) &&
                      q0 + NQ <= Sq && k0 + kTcM <= Sk;
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

    // dV += P^T.G and dK += dS^T.Q, P^T / dS^T straight from registers
#pragma unroll
    for (int kq = 0; kq < NQ / 16; ++kq) {
      uint32_t ap[4], ads[4];
      acc_to_a<T>(ap, s[2 * kq], s[2 * kq + 1]);
      acc_to_a<T>(ads, dp[2 * kq], dp[2 * kq + 1]);
#pragma unroll
      for (int np = 0; np < DP / 16; ++np) {
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

#pragma unroll
  for (int n = 0; n < DT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kj = kj0 + (e >> 1) * 8;
      const int d = n * 8 + gc + (e & 1);
      if (kj < Sk && d < D) {
        const long long o = (static_cast<long long>(b) * Sk + kj) * H * D +
                            static_cast<long long>(h) * D + d;
        dk[o] = ptt::from_f32<T>(dk_acc[n][e]);
        dv[o] = ptt::from_f32<T>(dv_acc[n][e]);
      }
    }
  }
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

  auto load_tile = [&](int it) {
    const int buf = it & 1;
    stage_tc<T, NK, DP>(Ks + buf * NK * RS, kb, ks.ss, it * NK, Sk, D, vec & 2);
    stage_tc<T, NK, DP>(Vs + buf * NK * RS, vb, vs.ss, it * NK, Sk, D, vec & 4);
  };
  stage_tc<T, kTcM, DP>(Qs, qb, qs.ss, q0, Sq, D, vec & 1);
  stage_tc<T, kTcM, DP>(Gs, gb, gs.ss, q0, Sq, D, vec & 8);
  load_tile(0);
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

    // dS in place of dP
    const bool full = !(causal && k0 + NK - 1 > q0 + offset) &&
                      q0 + kTcM <= Sq && k0 + NK <= Sk;
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

#pragma unroll
  for (int n = 0; n < DT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qi = qi0 + (e >> 1) * 8;
      const int d = n * 8 + gc + (e & 1);
      if (qi < Sq && d < D) {
        const long long o = (static_cast<long long>(b) * Sq + qi) * H * D +
                            static_cast<long long>(h) * D + d;
        dq[o] = ptt::from_f32<T>(dq_acc[n][e]);
      }
    }
  }
}

// ------------------------------------------------------------- launches
Ptrs ptrs(const long long* st, int which) {
  return Ptrs{st[3 * which], st[3 * which + 1], st[3 * which + 2]};
}

template <typename T, int DP, int KB>
cudaError_t launch_dkdv(const void* q, const void* k, const void* v,
                        const void* g, const float* lse, const float* r,
                        void* dk, void* dv, int B, int H, int Sq, int Sk,
                        int D, const long long* st, float scale, int causal,
                        cudaStream_t stream) {
  auto kernel = flash_bwd_dkdv_kernel<T, DP, KB>;
  const size_t smem = dkdv_smem_bytes<DP, KB>();
  cudaError_t err = ptt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sk + KB - 1) / KB, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g), lse, r,
      static_cast<T*>(dk), static_cast<T*>(dv), H, Sq, Sk, D, ptrs(st, 0),
      ptrs(st, 1), ptrs(st, 2), ptrs(st, 3), scale, causal);
  return cudaGetLastError();
}

template <typename T, int DP, int KB>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* g, const float* lse, const float* r,
                      void* dq, int B, int H, int Sq, int Sk, int D,
                      const long long* st, float scale, int causal,
                      cudaStream_t stream) {
  auto kernel = flash_bwd_dq_kernel<T, DP, KB>;
  const size_t smem = dq_smem_bytes<DP, KB>();
  cudaError_t err = ptt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + KB - 1) / KB, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g), lse, r,
      static_cast<T*>(dq), H, Sq, Sk, D, ptrs(st, 0), ptrs(st, 1),
      ptrs(st, 2), ptrs(st, 3), scale, causal);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_dkdv_tc(const void* q, const void* k, const void* v,
                           const void* g, const float* lse, const float* r,
                           void* dk, void* dv, int B, int H, int Sq, int Sk,
                           int D, const long long* st, float scale,
                           int causal, cudaStream_t stream) {
  // at head_dim 128 the streamed query tile is 32 rows, which keeps dk,
  // dv, S^T and dP^T in registers without spilling
  constexpr int NQ = DP == 64 ? 64 : 32;
  auto kernel = flash_bwd_dkdv_tc_kernel<T, DP, NQ>;
  const size_t smem = tc_smem_bytes<DP, NQ>(sizeof(T), 2);
  cudaError_t err = ptt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const void* x[4] = {q, k, v, g};
  const int vec = vec_mask(x, 4, st, D, sizeof(T));
  dim3 grid(B * H, (Sk + kTcM - 1) / kTcM);
  kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g), lse, r,
      static_cast<T*>(dk), static_cast<T*>(dv), H, Sq, Sk, D, ptrs(st, 0),
      ptrs(st, 1), ptrs(st, 2), ptrs(st, 3), scale, causal, vec);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_dq_tc(const void* q, const void* k, const void* v,
                         const void* g, const float* lse, const float* r,
                         void* dq, int B, int H, int Sq, int Sk, int D,
                         const long long* st, float scale, int causal,
                         cudaStream_t stream) {
  constexpr int NK = 64;
  auto kernel = flash_bwd_dq_tc_kernel<T, DP, NK>;
  const size_t smem = tc_smem_bytes<DP, NK>(sizeof(T), 0);
  cudaError_t err = ptt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const void* x[4] = {q, k, v, g};
  const int vec = vec_mask(x, 4, st, D, sizeof(T));
  dim3 grid(B * H, (Sq + kTcM - 1) / kTcM);
  kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g), lse, r,
      static_cast<T*>(dq), H, Sq, Sk, D, ptrs(st, 0), ptrs(st, 1),
      ptrs(st, 2), ptrs(st, 3), scale, causal, vec);
  return cudaGetLastError();
}

bool bad_shape(int B, int H, int Sq, int Sk, int D) {
  return D < 1 || D > 256 || B < 1 || H < 1 || Sq < 1 || Sk < 1;
}

// The body that takes a call: bf16 / f16 at head_dim <= 128 the tensor
// cores (head_dim padded to 64 or 128); f32 at head_dim <= 128 the SIMT
// body with 64-row tiles (padded to 64 or 128); every dtype at 128 <
// head_dim <= 256 the SIMT body with 32-row tiles (padded to 256).
// run_dkdv / run_dq launch the body this rule names, and the wrapper
// counts launches by it.
enum BwdBody : int { kBwdSimt = 0, kBwdTc16 = 1 };

int bwd_body(int dtype, int D) {
  return D <= 128 && dtype != ptt::kF32 ? kBwdTc16 : kBwdSimt;
}

// T is the C++ type of dtype code `dtype`.
template <typename T>
cudaError_t run_dkdv(int dtype, const void* q, const void* k, const void* v,
                     const void* g, const float* lse, const float* r,
                     void* dk, void* dv, int B, int H, int Sq, int Sk, int D,
                     const long long* st, float scale, int causal,
                     cudaStream_t s) {
  // each branch builds only the instantiations the rule names for T; a
  // rule that named another would get cudaErrorInvalidValue, not a
  // miscounted launch
  if (bwd_body(dtype, D) == kBwdSimt) {
    if (D > 128)
      return launch_dkdv<T, 256, 32>(q, k, v, g, lse, r, dk, dv, B, H, Sq,
                                     Sk, D, st, scale, causal, s);
    if constexpr (std::is_same<T, float>::value)
      return D <= 64 ? launch_dkdv<T, 64, 64>(q, k, v, g, lse, r, dk, dv, B,
                                              H, Sq, Sk, D, st, scale, causal,
                                              s)
                     : launch_dkdv<T, 128, 64>(q, k, v, g, lse, r, dk, dv, B,
                                               H, Sq, Sk, D, st, scale,
                                               causal, s);
  } else if constexpr (!std::is_same<T, float>::value) {
    return D <= 64 ? launch_dkdv_tc<T, 64>(q, k, v, g, lse, r, dk, dv, B, H,
                                           Sq, Sk, D, st, scale, causal, s)
                   : launch_dkdv_tc<T, 128>(q, k, v, g, lse, r, dk, dv, B, H,
                                            Sq, Sk, D, st, scale, causal, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t run_dq(int dtype, const void* q, const void* k, const void* v,
                   const void* g, const float* lse, const float* r, void* dq,
                   int B, int H, int Sq, int Sk, int D, const long long* st,
                   float scale, int causal, cudaStream_t s) {
  if (bwd_body(dtype, D) == kBwdSimt) {   // as run_dkdv
    if (D > 128)
      return launch_dq<T, 256, 32>(q, k, v, g, lse, r, dq, B, H, Sq, Sk, D,
                                   st, scale, causal, s);
    if constexpr (std::is_same<T, float>::value)
      return D <= 64 ? launch_dq<T, 64, 64>(q, k, v, g, lse, r, dq, B, H, Sq,
                                            Sk, D, st, scale, causal, s)
                     : launch_dq<T, 128, 64>(q, k, v, g, lse, r, dq, B, H,
                                             Sq, Sk, D, st, scale, causal, s);
  } else if constexpr (!std::is_same<T, float>::value) {
    return D <= 64 ? launch_dq_tc<T, 64>(q, k, v, g, lse, r, dq, B, H, Sq,
                                         Sk, D, st, scale, causal, s)
                   : launch_dq_tc<T, 128>(q, k, v, g, lse, r, dq, B, H, Sq,
                                          Sk, D, st, scale, causal, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

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
    err = run_dkdv<scalar_t>(dtype, q, k, v, g, l, rr, dk, dv, B, H, Sq,
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
    err = run_dq<scalar_t>(dtype, q, k, v, g, l, rr, dq, B, H, Sq, Sk, D,
                           strides, scale, causal, s);
  });
  return static_cast<int>(err);
}

// The body both backward entries launch for (dtype, D): 0 SIMT, 1 the
// 16-bit tensor cores (the wrapper counts launches per body).
extern "C" int ptt_flash_attention_bwd_body(int dtype, int D) {
  return bwd_body(dtype, D);
}
