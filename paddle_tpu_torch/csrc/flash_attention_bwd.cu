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
// owner, so the result is deterministic.
//
// What bounds it on this card: per visible (query, key) pair K2a does four
// D-long products (s, dp, dv, dk: 8*D operations) and K2b three (6*D)
// against a few bytes per row, so at the training shape (S = 1024, D = 64)
// both are far above the H100's ~295 operations per byte and a good kernel
// is bound by arithmetic.  These do the products with plain f32 FMAs out
// of shared memory (no tensor cores), so they reach a fraction of the
// 67 TFLOP/s f32 rate, not of the 989 TFLOP/s tensor-core rate: right and
// simple first; mma/wgmma and a fused single-pass backward are later work.
//
// Design.  The TPU grid's sequential sweep with scratch accumulators
// (init at the first step, write-out at the last) becomes a loop inside
// one block of 256 threads:
//   K2a: one block per (64-key tile, batch * head).  K and V stay staged in
//        shared memory; the loop walks the 64-query tiles the causal mask
//        leaves visible, staging q, g, lse and r.  Four threads own one key
//        row: each computes 16 of the tile's 64 (s, dp) pairs, writes p and
//        ds transposed to shared memory, and accumulates D/4 columns of dk
//        and dv in registers.
//   K2b: one block per (64-query tile, batch * head).  q, g, lse and r stay;
//        the loop walks 64-key tiles up to the causal bound.  Four threads
//        own one query row and accumulate D/4 columns of dq.
// Tiles are staged as f32 with a +1 row pad (no bank conflicts on the
// row-strided reads), which passes the 48 KB default, so each launch opts
// in to the dynamic shared memory it needs (100 / 166 KB for K2a and 83 /
// 149 KB for K2b at head_dim 64 / 128).  head_dim <= 128.  q/k/v/g are read
// in the public [B, S, H, D] layout straight from their strides (unit
// stride in head_dim), so the model's head-major qkv split needs no copy;
// the ragged last tiles are masked here, where the TPU path padded.
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kB = 64;                  // rows (queries or keys) per tile
constexpr int kThreads = 256;
constexpr int kTPR = kThreads / kB;     // threads per owned row (4)
constexpr int kCols = kB / kTPR;        // scores per thread per tile (16)
constexpr int kPS = kB + 1;             // padded row of a [64][64] tile

template <int DP>
constexpr size_t dkdv_smem_bytes() {
  // K, V, Q, G [kB][DP+1]; P^T, dS^T [kB][kB+1]; lse, r [kB]
  return sizeof(float) * (4 * kB * (DP + 1) + 2 * kB * kPS + 2 * kB);
}

template <int DP>
constexpr size_t dq_smem_bytes() {
  // Q, G, K, V [kB][DP+1]; dS [kB][kB+1]
  return sizeof(float) * (4 * kB * (DP + 1) + kB * kPS);
}

struct Ptrs {
  long long sb, ss, sh;                 // element strides: batch, seq, head
};

// Stage rows [row0, row0 + kB) of one (batch, head) slice as f32 into a
// [kB][DP+1] tile; rows past n and columns past D are zero.
template <typename T, int DP>
__device__ __forceinline__ void stage(float* dst, const T* src, long long ss,
                                      int row0, int n, int D) {
  for (int idx = threadIdx.x; idx < kB * DP; idx += kThreads) {
    const int rr = idx / DP;
    const int d = idx % DP;
    const int row = row0 + rr;
    dst[rr * (DP + 1) + d] =
        (row < n && d < D) ? ptt::to_f32(src[row * ss + d]) : 0.f;
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ g,
                      const float* __restrict__ lse,
                      const float* __restrict__ rc, T* __restrict__ dk,
                      T* __restrict__ dv, int H, int Sq, int Sk, int D,
                      Ptrs qs, Ptrs ks, Ptrs vs, Ptrs gs, float scale,
                      int causal) {
  constexpr int RS = DP + 1;
  constexpr int DPT = DP / kTPR;        // dk / dv columns per thread
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kB * RS;
  float* Qs = Vs + kB * RS;
  float* Gs = Qs + kB * RS;
  float* Pt = Gs + kB * RS;             // p^T  [key][query]
  float* Dt = Pt + kB * kPS;            // ds^T [key][query]
  float* Ls = Dt + kB * kPS;
  float* Rs = Ls + kB;

  const int tid = threadIdx.x;
  const int j = tid / kTPR;             // this thread's key row in the tile
  const int sub = tid % kTPR;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = blockIdx.x * kB;
  const int kj = k0 + j;
  const int offset = Sk - Sq;

  const T* qb = q + b * qs.sb + h * qs.sh;
  const T* kb = k + b * ks.sb + h * ks.sh;
  const T* vb = v + b * vs.sb + h * vs.sh;
  const T* gb = g + b * gs.sb + h * gs.sh;
  const float* lb = lse + static_cast<long long>(bh) * Sq;
  const float* rb = rc + static_cast<long long>(bh) * Sq;

  stage<T, DP>(Ks, kb, ks.ss, k0, Sk, D);
  stage<T, DP>(Vs, vb, vs.ss, k0, Sk, D);

  float dk_acc[DPT], dv_acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  // causal: query i sees this tile's first key k0 once i >= k0 - offset
  int qstart = 0;
  if (causal) qstart = (max(0, k0 - offset) / kB) * kB;

  const float* krow = Ks + j * RS;
  const float* vrow = Vs + j * RS;
  float* prow = Pt + j * kPS;
  float* drow = Dt + j * kPS;
  for (int q0 = qstart; q0 < Sq; q0 += kB) {
    __syncthreads();                    // K/V staged / last tile consumed
    stage<T, DP>(Qs, qb, qs.ss, q0, Sq, D);
    stage<T, DP>(Gs, gb, gs.ss, q0, Sq, D);
    if (tid < kB) {
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
    __syncwarp();                       // the row's 4 threads share a warp
#pragma unroll 4
    for (int i = 0; i < kB; ++i) {
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

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ g,
                    const float* __restrict__ lse,
                    const float* __restrict__ rc, T* __restrict__ dq, int H,
                    int Sq, int Sk, int D, Ptrs qs, Ptrs ks, Ptrs vs,
                    Ptrs gs, float scale, int causal) {
  constexpr int RS = DP + 1;
  constexpr int DPT = DP / kTPR;        // dq columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Gs = Qs + kB * RS;
  float* Ks = Gs + kB * RS;
  float* Vs = Ks + kB * RS;
  float* Ds = Vs + kB * RS;             // ds [query][key]

  const int tid = threadIdx.x;
  const int i = tid / kTPR;             // this thread's query row in the tile
  const int sub = tid % kTPR;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * kB;
  const int qi = q0 + i;
  const int offset = Sk - Sq;

  const T* qb = q + b * qs.sb + h * qs.sh;
  const T* kb = k + b * ks.sb + h * ks.sh;
  const T* vb = v + b * vs.sb + h * vs.sh;
  const T* gb = g + b * gs.sb + h * gs.sh;
  const float l_i = qi < Sq ? lse[static_cast<long long>(bh) * Sq + qi] : 0.f;
  const float r_i = qi < Sq ? rc[static_cast<long long>(bh) * Sq + qi] : 0.f;

  stage<T, DP>(Qs, qb, qs.ss, q0, Sq, D);
  stage<T, DP>(Gs, gb, gs.ss, q0, Sq, D);

  float dq_acc[DPT];
#pragma unroll
  for (int c = 0; c < DPT; ++c) dq_acc[c] = 0.f;

  // causal: the tile's last valid query sees keys up to q_last + offset
  int kend = Sk;
  if (causal) kend = min(Sk, min(q0 + kB, Sq) - 1 + offset + 1);

  const float* qrow = Qs + i * RS;
  const float* grow = Gs + i * RS;
  float* drow = Ds + i * kPS;
  for (int k0 = 0; k0 < kend; k0 += kB) {
    __syncthreads();                    // Q/G staged / last tile consumed
    stage<T, DP>(Ks, kb, ks.ss, k0, Sk, D);
    stage<T, DP>(Vs, vb, vs.ss, k0, Sk, D);
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
    for (int j = 0; j < kB; ++j) {
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

Ptrs ptrs(const long long* st, int which) {
  return Ptrs{st[3 * which], st[3 * which + 1], st[3 * which + 2]};
}

template <typename T, int DP>
cudaError_t launch_dkdv(const void* q, const void* k, const void* v,
                        const void* g, const float* lse, const float* r,
                        void* dk, void* dv, int B, int H, int Sq, int Sk,
                        int D, const long long* st, float scale, int causal,
                        cudaStream_t stream) {
  auto kernel = flash_bwd_dkdv_kernel<T, DP>;
  const size_t smem = dkdv_smem_bytes<DP>();
  cudaError_t err = ptt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sk + kB - 1) / kB, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g), lse, r,
      static_cast<T*>(dk), static_cast<T*>(dv), H, Sq, Sk, D, ptrs(st, 0),
      ptrs(st, 1), ptrs(st, 2), ptrs(st, 3), scale, causal);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* g, const float* lse, const float* r,
                      void* dq, int B, int H, int Sq, int Sk, int D,
                      const long long* st, float scale, int causal,
                      cudaStream_t stream) {
  auto kernel = flash_bwd_dq_kernel<T, DP>;
  const size_t smem = dq_smem_bytes<DP>();
  cudaError_t err = ptt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + kB - 1) / kB, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g), lse, r,
      static_cast<T*>(dq), H, Sq, Sk, D, ptrs(st, 0), ptrs(st, 1),
      ptrs(st, 2), ptrs(st, 3), scale, causal);
  return cudaGetLastError();
}

bool bad_shape(int B, int H, int Sq, int Sk, int D) {
  return D < 1 || D > 128 || B < 1 || H < 1 || Sq < 1 || Sk < 1;
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
    if (D <= 64)
      err = launch_dkdv<scalar_t, 64>(q, k, v, g, l, rr, dk, dv, B, H, Sq, Sk,
                                      D, strides, scale, causal, s);
    else
      err = launch_dkdv<scalar_t, 128>(q, k, v, g, l, rr, dk, dv, B, H, Sq,
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
    if (D <= 64)
      err = launch_dq<scalar_t, 64>(q, k, v, g, l, rr, dq, B, H, Sq, Sk, D,
                                    strides, scale, causal, s);
    else
      err = launch_dq<scalar_t, 128>(q, k, v, g, l, rr, dq, B, H, Sq, Sk, D,
                                     strides, scale, causal, s);
  });
  return static_cast<int>(err);
}
