// The paged flash-decode kernel body shared by K3 / K5a
// (paged_flash_decode.cu: pools in q's dtype) and K4 / K5b
// (paged_flash_decode_q.cu: int8 pools with float32 scale pools).
//
// Same function for all four: one query token per row attends the global
// page pools [P, ps, HKV, D] through page_table [B, NP] and seq_lens [B];
// GQA query head h reads kv head h / g (g = H / HKV); rows with length 0
// write zeros; lengths past NP * ps clamp to the table.  Online softmax in
// f32, output in q's dtype.  With int8 pools each staged element is
// f32(q8) * scale, scale = scales[page, t, kh] (the TPU kernel's
// k.astype(f32) * ks), so the page is dequantized in shared memory and
// never exists at full precision in device memory.
//
// BOUNDED (K3, K4): the sweep stops at the row's last valid page,
// ceil(len / ps), so table slots past a row's length are never read.
// !BOUNDED (K5a, K5b, the TPU package's legacy full-sweep kernels): the
// block stages every one of the row's NP table pages, dead ones included,
// skips the compute of pages past len (the TPU kernel's
// pl.when(i * ps < seq_len)) and finalizes after the last table page.  The
// arithmetic of the pages that are computed is the same code in the same
// order, so both flags give bit-equal outputs.
//
// What bounds it on this card: bytes.  Each valid K/V element is used
// once per query head of its group (2 * g operations per element against
// 1-4 bytes), so the kernel is limited by how fast it streams the valid
// pages.  The design reads each page once per kv head for all g query
// heads of the group (the TPU kernel's _accum_page grouping).  The one
// block per (row, kv head) grid under-fills the 132 SMs at small batch
// (8 x 12 = 96 blocks at the served shapes); splitting a row's pages over
// several blocks with a logsumexp merge is later work.
//
// Design: grid (B, HKV), one warp per query head of the group.  The block
// loads its own page ids from the table (Hopper has no scalar prefetch),
// stages each page's K and V in shared memory as f32 with 16-byte loads,
// all of a thread's loads (and, for int8 pools, their scales) in flight
// before the first is used, and each warp holds its query head in
// registers with lanes over D; a token's score is a warp-shuffle sum.
#pragma once

#include "common.cuh"

#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace ptt {
namespace paged {

constexpr int kBatch = 8;   // 16-byte loads in flight per thread per pass

// One staged element: the pool value in f32, times its scale for int8.
template <typename KV>
__device__ __forceinline__ float element(KV x, float s) {
  if constexpr (std::is_same<KV, int8_t>::value) {
    return to_f32(x) * s;
  } else {
    return to_f32(x);
  }
}

// Stage one page's K and V rows of one kv head into shared memory as f32.
// kscale / vscale point at the page's scale of token 0 for this kv head
// (token t's at t * HKV); unused for pools in q's dtype.  VEC16: every row
// is a whole number of 16-byte vectors and the pools are 16-byte aligned,
// so each thread issues up to kBatch vector loads of K and of V before it
// converts any — a page costs about one memory latency rather than one per
// element.  Otherwise a scalar loop does the same.
template <typename KV, bool VEC16>
__device__ __forceinline__ void stage_page(const KV* __restrict__ kpage,
                                           const KV* __restrict__ vpage,
                                           const float* __restrict__ kscale,
                                           const float* __restrict__ vscale,
                                           long long tok_stride, int HKV,
                                           int ps, int D, float* Ks,
                                           float* Vs) {
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  if constexpr (VEC16) {
    constexpr int E = 16 / sizeof(KV);           // elements per vector
    const int row_vecs = D / E;
    const int nvec = ps * row_vecs;
    for (int base = threadIdx.x; base < nvec; base += kBatch * blockDim.x) {
      uint4 kr[kBatch], vr[kBatch];
      float ks[kBatch], vs[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int idx = base + j * blockDim.x;
        if (idx < nvec) {
          const int t = idx / row_vecs;
          const long long off = t * tok_stride + (idx - t * row_vecs) * E;
          kr[j] = *reinterpret_cast<const uint4*>(kpage + off);
          vr[j] = *reinterpret_cast<const uint4*>(vpage + off);
          if constexpr (kQuant) {
            ks[j] = kscale[t * HKV];
            vs[j] = vscale[t * HKV];
          } else {
            ks[j] = vs[j] = 1.f;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int idx = base + j * blockDim.x;
        if (idx < nvec) {
          const KV* ke = reinterpret_cast<const KV*>(&kr[j]);
          const KV* ve = reinterpret_cast<const KV*>(&vr[j]);
#pragma unroll
          for (int e = 0; e < E; ++e) {
            Ks[idx * E + e] = element(ke[e], ks[j]);
            Vs[idx * E + e] = element(ve[e], vs[j]);
          }
        }
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < ps * D; idx += blockDim.x) {
      const int t = idx / D;
      const int d = idx - t * D;
      const float ks = kQuant ? kscale[t * HKV] : 1.f;
      const float vs = kQuant ? vscale[t * HKV] : 1.f;
      Ks[idx] = element(kpage[t * tok_stride + d], ks);
      Vs[idx] = element(vpage[t * tok_stride + d], vs);
    }
  }
}

// q [B, H, D] in T (strides qsb, qsh); kp / vp [P, ps, HKV, D] in KV;
// ks / vs [P, ps, HKV] float32 when KV is int8 (else null); o [B, H, D].
template <typename T, typename KV, int VEC, bool VEC16, bool BOUNDED>
__global__ void paged_flash_decode_kernel(
    const T* __restrict__ q, const KV* __restrict__ kp,
    const KV* __restrict__ vp, const float* __restrict__ ks,
    const float* __restrict__ vs, const int* __restrict__ table,
    const int* __restrict__ lens, T* __restrict__ o, int H, int HKV, int D,
    int ps, int NP, long long qsb, long long qsh, float scale) {
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  extern __shared__ float smem[];
  const int g = H / HKV;
  float* Ks = smem;                     // [ps][D]
  float* Vs = Ks + ps * D;              // [ps][D]
  float* Ss = Vs + ps * D;              // [g][ps] scores
  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int h = kh * g + warp;

  const int len = max(0, min(lens[b], NP * ps));
  const int npages = (len + ps - 1) / ps;
  const int nsweep = BOUNDED ? npages : NP;

  float qr[VEC], acc[VEC];
  const T* qrow = q + b * qsb + h * qsh;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int d = lane + 32 * i;
    qr[i] = d < D ? to_f32(qrow[d]) : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;
  const long long tok_stride = static_cast<long long>(HKV) * D;
  const long long page_stride = tok_stride * ps;
  const long long scale_page_stride = static_cast<long long>(HKV) * ps;
  float* srow = Ss + warp * ps;

  for (int i = 0; i < nsweep; ++i) {
    const long long page = table[static_cast<long long>(b) * NP + i];
    const KV* kpage = kp + page * page_stride + static_cast<long long>(kh) * D;
    const KV* vpage = vp + page * page_stride + static_cast<long long>(kh) * D;
    const float* kspage = kQuant ? ks + page * scale_page_stride + kh : nullptr;
    const float* vspage = kQuant ? vs + page * scale_page_stride + kh : nullptr;
    __syncthreads();                    // the previous page is consumed
    stage_page<KV, VEC16>(kpage, vpage, kspage, vspage, tok_stride, HKV, ps,
                          D, Ks, Vs);
    __syncthreads();
    if (!BOUNDED && i >= npages) continue;   // a dead page: staged, unused

    const int ntok = min(ps, len - i * ps);   // >= 1 inside the bound
    float pmax = -INFINITY;
#pragma unroll 4
    for (int t = 0; t < ntok; ++t) {
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int d = lane + 32 * j;
        if (d < D) part += qr[j] * Ks[t * D + d];
      }
      const float s = warp_sum(part) * scale;
      pmax = fmaxf(pmax, s);
      if (lane == 0) srow[t] = s;
    }
    __syncwarp();
    const float m_new = fmaxf(m, pmax);
    const float alpha = __expf(m - m_new);    // m = -inf on the first page
    l *= alpha;
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] *= alpha;
    for (int t = 0; t < ntok; ++t) {
      const float p = __expf(srow[t] - m_new);
      l += p;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int d = lane + 32 * j;
        if (d < D) acc[j] += p * Vs[t * D + d];
      }
    }
    m = m_new;
  }

  T* orow = o + (static_cast<long long>(b) * H + h) * D;
  const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const int d = lane + 32 * j;
    if (d < D) orow[d] = from_f32<T>(acc[j] * inv);
  }
}

template <typename T, typename KV, int VEC>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const float* ks, const float* vs, const int* table,
                   const int* lens, void* o, int B, int H, int HKV, int D,
                   int ps, int NP, long long qsb, long long qsh, float scale,
                   bool bounded, cudaStream_t stream) {
  const bool vec16 = (D * sizeof(KV)) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(kp) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(vp) % 16 == 0;
  auto kernel =
      bounded ? (vec16 ? paged_flash_decode_kernel<T, KV, VEC, true, true>
                       : paged_flash_decode_kernel<T, KV, VEC, false, true>)
              : (vec16 ? paged_flash_decode_kernel<T, KV, VEC, true, false>
                       : paged_flash_decode_kernel<T, KV, VEC, false, false>);
  const int g = H / HKV;
  const size_t smem = sizeof(float) * (2 * static_cast<size_t>(ps) * D +
                                       static_cast<size_t>(g) * ps);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B, HKV);
  kernel<<<grid, 32 * g, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(kp),
      static_cast<const KV*>(vp), ks, vs, table, lens, static_cast<T*>(o), H,
      HKV, D, ps, NP, qsb, qsh, scale);
  return cudaGetLastError();
}

// Checks the shape limits every entry shares, then picks the register
// width VEC (head_dim <= 32 * VEC).  Returns the launch's cudaError_t.
template <typename T, typename KV>
cudaError_t dispatch(const void* q, const void* kp, const void* vp,
                     const float* ks, const float* vs, const void* table,
                     const void* lens, void* o, int B, int H, int HKV, int D,
                     int ps, int NP, long long qsb, long long qsh,
                     float scale, int bounded, void* stream) {
  if (B < 1 || HKV < 1 || H % HKV != 0 || H / HKV > 32 || D < 1 || D > 256 ||
      ps < 1 || NP < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(table);
  const int* ln = static_cast<const int*>(lens);
  const bool bd = bounded != 0;
  if (D <= 32)
    return launch<T, KV, 1>(q, kp, vp, ks, vs, tb, ln, o, B, H, HKV, D, ps,
                            NP, qsb, qsh, scale, bd, s);
  if (D <= 64)
    return launch<T, KV, 2>(q, kp, vp, ks, vs, tb, ln, o, B, H, HKV, D, ps,
                            NP, qsb, qsh, scale, bd, s);
  if (D <= 128)
    return launch<T, KV, 4>(q, kp, vp, ks, vs, tb, ln, o, B, H, HKV, D, ps,
                            NP, qsb, qsh, scale, bd, s);
  return launch<T, KV, 8>(q, kp, vp, ks, vs, tb, ln, o, B, H, HKV, D, ps, NP,
                          qsb, qsh, scale, bd, s);
}

}  // namespace paged
}  // namespace ptt
