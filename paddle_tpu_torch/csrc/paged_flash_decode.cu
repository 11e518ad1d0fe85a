// K3: length-bounded paged flash decode, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/paged_attention.py
// (_paged_flash_pallas -> _paged_flash_kernel, with _accum_page and the
// _bounded_page_map clamp).  Same function: one query token per row
// attends the global page pools [P, ps, HKV, D] through page_table [B, NP]
// and seq_lens [B]; GQA query head h reads kv head h / g (g = H / HKV);
// the sweep stops at the row's last valid page, so table slots past a
// row's length are never read; rows with length 0 write zeros; lengths
// past NP * ps clamp to the table.  Online softmax in f32, output in the
// input dtype.
//
// What bounds it on this card: bytes.  Each valid K/V element is used
// once per query head of its group (2 * g operations per element against
// 2-4 bytes), so the kernel is limited by how fast it streams the valid
// pages from device memory.  The design reads each page once per kv head
// for all g query heads of the group (the TPU kernel's _accum_page
// grouping) and never touches dead pages.  The one block per (row, kv
// head) grid under-fills the 132 SMs at small batch (8 x 12 = 96 blocks
// at the served shapes); splitting a row's pages over several blocks with
// a logsumexp merge is later work.
//
// Design: grid (B, HKV), one warp per query head of the group.  The block
// loads its own page ids from the table (Hopper has no scalar prefetch),
// stages each valid page's K and V in shared memory as f32 with 16-byte
// loads, all of a thread's loads in flight before the first is used, and
// each warp holds its query head in registers with lanes over D; a token's
// score is a warp-shuffle sum.
#include "common.cuh"

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBatch = 8;   // 16-byte loads in flight per thread per pass

// Stage one page's K and V rows of kv head `kh` into shared memory as f32.
// VEC16: every row is a whole number of 16-byte vectors and the pools are
// 16-byte aligned, so each thread issues up to kBatch vector loads of K
// and of V before it converts any — a page costs about one memory latency
// rather than one per element.  Otherwise a scalar loop does the same.
template <typename T, bool VEC16>
__device__ __forceinline__ void stage_page(const T* __restrict__ kpage,
                                           const T* __restrict__ vpage,
                                           long long tok_stride, int ps, int D,
                                           float* Ks, float* Vs) {
  if constexpr (VEC16) {
    constexpr int E = 16 / sizeof(T);           // elements per vector
    const int row_vecs = D / E;
    const int nvec = ps * row_vecs;
    for (int base = threadIdx.x; base < nvec; base += kBatch * blockDim.x) {
      uint4 kr[kBatch], vr[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int idx = base + j * blockDim.x;
        if (idx < nvec) {
          const int t = idx / row_vecs;
          const long long off = t * tok_stride + (idx - t * row_vecs) * E;
          kr[j] = *reinterpret_cast<const uint4*>(kpage + off);
          vr[j] = *reinterpret_cast<const uint4*>(vpage + off);
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int idx = base + j * blockDim.x;
        if (idx < nvec) {
          const T* ke = reinterpret_cast<const T*>(&kr[j]);
          const T* ve = reinterpret_cast<const T*>(&vr[j]);
#pragma unroll
          for (int e = 0; e < E; ++e) {
            Ks[idx * E + e] = ptt::to_f32(ke[e]);
            Vs[idx * E + e] = ptt::to_f32(ve[e]);
          }
        }
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < ps * D; idx += blockDim.x) {
      const int t = idx / D;
      const int d = idx - t * D;
      Ks[idx] = ptt::to_f32(kpage[t * tok_stride + d]);
      Vs[idx] = ptt::to_f32(vpage[t * tok_stride + d]);
    }
  }
}

template <typename T, int VEC, bool VEC16>
__global__ void paged_flash_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
    const int* __restrict__ table, const int* __restrict__ lens,
    T* __restrict__ o, int H, int HKV, int D, int ps, int NP,
    long long qsb, long long qsh, float scale) {
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

  float qr[VEC], acc[VEC];
  const T* qrow = q + b * qsb + h * qsh;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int d = lane + 32 * i;
    qr[i] = d < D ? ptt::to_f32(qrow[d]) : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;
  const long long tok_stride = static_cast<long long>(HKV) * D;
  const long long page_stride = tok_stride * ps;
  float* srow = Ss + warp * ps;

  for (int i = 0; i < npages; ++i) {
    const long long page = table[static_cast<long long>(b) * NP + i];
    const T* kpage = kp + page * page_stride + static_cast<long long>(kh) * D;
    const T* vpage = vp + page * page_stride + static_cast<long long>(kh) * D;
    __syncthreads();                    // the previous page is consumed
    stage_page<T, VEC16>(kpage, vpage, tok_stride, ps, D, Ks, Vs);
    __syncthreads();

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
      const float s = ptt::warp_sum(part) * scale;
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
    if (d < D) orow[d] = ptt::from_f32<T>(acc[j] * inv);
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* table, const int* lens, void* o, int B, int H,
                   int HKV, int D, int ps, int NP, long long qsb, long long qsh,
                   float scale, cudaStream_t stream) {
  const bool vec16 = (D * sizeof(T)) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(kp) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(vp) % 16 == 0;
  auto kernel = vec16 ? paged_flash_decode_kernel<T, VEC, true>
                      : paged_flash_decode_kernel<T, VEC, false>;
  const int g = H / HKV;
  const size_t smem = sizeof(float) * (2 * static_cast<size_t>(ps) * D +
                                       static_cast<size_t>(g) * ps);
  cudaError_t err = ptt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B, HKV);
  kernel<<<grid, 32 * g, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), table, lens, static_cast<T*>(o), H, HKV, D,
      ps, NP, qsb, qsh, scale);
  return cudaGetLastError();
}

}  // namespace

// q: [B, H, D] with element strides (qsb, qsh), head dim unit-stride.
// k_pages / v_pages: contiguous [P, ps, HKV, D]; table: contiguous int32
// [B, NP]; lens: int32 [B]; o: contiguous [B, H, D] in the input dtype.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int ptt_paged_flash_decode(const void* q, const void* k_pages,
                                      const void* v_pages, const void* table,
                                      const void* lens, void* o, int dtype,
                                      int B, int H, int HKV, int D, int ps,
                                      int NP, long long qsb, long long qsh,
                                      float scale, void* stream) {
  if (B < 1 || HKV < 1 || H % HKV != 0 || H / HKV > 32 || D < 1 || D > 256 ||
      ps < 1 || NP < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(table);
  const int* ln = static_cast<const int*>(lens);
  cudaError_t err = cudaSuccess;
  PTT_DISPATCH_DTYPE(dtype, {
    if (D <= 32)
      err = launch<scalar_t, 1>(q, k_pages, v_pages, tb, ln, o, B, H, HKV, D,
                                ps, NP, qsb, qsh, scale, s);
    else if (D <= 64)
      err = launch<scalar_t, 2>(q, k_pages, v_pages, tb, ln, o, B, H, HKV, D,
                                ps, NP, qsb, qsh, scale, s);
    else if (D <= 128)
      err = launch<scalar_t, 4>(q, k_pages, v_pages, tb, ln, o, B, H, HKV, D,
                                ps, NP, qsb, qsh, scale, s);
    else
      err = launch<scalar_t, 8>(q, k_pages, v_pages, tb, ln, o, B, H, HKV, D,
                                ps, NP, qsb, qsh, scale, s);
  });
  return static_cast<int>(err);
}
