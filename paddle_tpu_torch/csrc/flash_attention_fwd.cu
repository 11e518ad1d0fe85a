// K1: flash attention forward, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/flash_attention.py
// (_flash_fwd -> _fa_kernel).  Same function: blocked attention with the
// online softmax (running max m, denominator l, accumulator acc) kept in
// f32, the causal mask aligned bottom-right (key j is visible to query i
// when j <= i + (Sk - Sq)), key tiles wholly above the diagonal skipped,
// o written in the input dtype and the per-row logsumexp written in f32.
//
// What bounds it on this card: at the prefill shapes of the served model
// (S up to 1024, D = 64) the work is about 4 * S^2 * D / 2 operations per
// (batch, head) against 4 * S * D * 2 bytes, far above the H100's ~295
// operations per byte, so a good kernel is bound by arithmetic.  This one
// does the two products with plain f32 FMAs out of shared memory (no
// tensor cores), so it reaches a fraction of the 67 TFLOP/s f32 rate,
// not of the 989 TFLOP/s tensor-core rate: simple and right first;
// mma/wgmma, TMA and warp specialisation are later work.
//
// Design: one block of 256 threads per (64-row query tile, batch * head).
// The TPU kernel's sequential key-block grid axis becomes a loop inside
// the block over 64-key tiles staged in shared memory (as f32), stopping
// at the causal bound.  Four threads own one query row: each computes 16
// of the tile's 64 scores and D/4 output columns; row max and row sum are
// reduced with two warp shuffles.  q/k/v are read in the public
// [B, S, H, D] layout straight from their strides (the head dim must be
// unit-stride), so the qkv split of the model needs no copy; the ragged
// last query and key tiles are masked here, where the TPU path padded.
#include "common.cuh"

#include <math.h>

namespace {

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
    if (D <= 64)
      err = launch<scalar_t, 64>(q, k, v, o, lse_f, B, H, Sq, Sk, D, strides,
                                 scale, causal, s);
    else if (D <= 128)
      err = launch<scalar_t, 128>(q, k, v, o, lse_f, B, H, Sq, Sk, D, strides,
                                  scale, causal, s);
    else
      err = launch<scalar_t, 256>(q, k, v, o, lse_f, B, H, Sq, Sk, D, strides,
                                  scale, causal, s);
  });
  return static_cast<int>(err);
}
