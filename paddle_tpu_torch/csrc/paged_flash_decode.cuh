// The split-K paged flash-decode kernel body shared by K3 / K5a
// (paged_flash_decode.cu: pools in q's dtype) and K4 / K5b
// (paged_flash_decode_q.cu: int8 pools with float32 scale pools).
//
// Same function for all four: one query token per row attends the global
// page pools [P, ps, HKV, D] through page_table [B, NP] and seq_lens [B];
// GQA query head h reads kv head h / g (g = H / HKV); rows with length 0
// write zeros; lengths past NP * ps clamp to the table.  Online softmax in
// f32, output in q's dtype.  With int8 pools every element is
// f32(q8) * scale[page, t, kh] (the TPU kernel's k.astype(f32) * ks),
// applied at use: the page is staged as int8 and never exists at full
// precision in device memory.
//
// What bounds it on this card: bytes.  Each valid K/V element is used
// once per query head of its group (2 * g operations per element against
// 1-4 bytes), so the kernel is limited by how fast it streams the valid
// pages; each page is read once per kv head for all g query heads (the
// TPU kernel's _accum_page grouping).  At the served shapes (8 rows of a
// few hundred tokens) that is a few MB: the time goes to latency unless
// many pages are in flight at once.
//
// Design: split-K.  The grid is (B, HKV, nsplit); split s owns the fixed
// table-slot range [s * chunk, (s + 1) * chunk).  The host picks nsplit
// from B * HKV and NP alone (the lengths stay on the device: no sync, so
// the decode step stays capturable in a CUDA graph); at run time a split
// clips its range to the row's length.  A block of 4 warps streams its
// range in tiles of 32 tokens (tokens, not pages, so any page size works;
// each thread looks its pages up in the table) through a double-buffered
// ring of 16-byte cp.async copies in the pools' storage dtype, rows padded
// by 16 bytes; the next tile loads while the current one is scored.  A
// tile is scored by (token, head) items, a few lanes owning one item's
// whole dot product over D out of shared memory; one warp per query head
// does the tile's max and sum; P.V is accumulated in registers by threads
// that each own one (head, column) output over a subset of the tile's
// tokens.  Each split writes its partial (m, l, acc[D]) in f32 to a
// workspace the wrapper allocates; a second small kernel merges the splits
// of each (row, head) in split order.  No atomics: two launches give the
// same bits.  A split with no valid token writes m = -inf, l = 0, and an
// empty row merges to zeros.
//
// BOUNDED (K3, K4): a split loads only the pages below ceil(len / ps), so
// table slots past a row's length are never read.  !BOUNDED (K5a, K5b,
// the TPU package's legacy full-sweep kernels): a split stages every slot
// of its range, dead pages included, and computes only the tiles that hold
// valid tokens, with the same code in the same order, so both flags give
// bit-equal outputs.
#pragma once

#include "common.cuh"
#include "mma.cuh"

#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace ptt {
namespace paged {

using tc::cp_async16;
using tc::cp_async4;
using tc::cp_async_commit;
using tc::cp_async_wait;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTT = 32;                 // tokens per staged tile (a warp's lanes)

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Bytes of one staged token row: whole 16-byte chunks and a 16-byte pad,
// so 16-byte reads of neighbouring rows fall on distinct banks.
__host__ __device__ inline int row_bytes(int D, int esize) {
  return (D * esize + 15) / 16 * 16 + 16;
}

// K and V rings [2][kTT][row], their scale rings [2][kTT], q [g][D], the
// tile's scores [g][kTT], m / l / alpha [g], the token-group sums [kThreads]
inline size_t smem_bytes(int D, int esize, int g) {
  return 4 * static_cast<size_t>(kTT) * row_bytes(D, esize) +
         sizeof(float) * (4 * kTT + static_cast<size_t>(g) * D + g * kTT +
                          3 * g + kThreads);
}

// Outputs (head, column) of a block: NO = g * D, handled by NOP threads
// (a power of two, at most kThreads) in NACC passes; when NO < kThreads,
// kThreads / NOP threads share an output, each over every (kThreads /
// NOP)-th token.
__host__ __device__ inline int outputs_per_pass(int NO) {
  int nop = 1;
  while (nop < NO && nop < kThreads) nop <<= 1;
  return nop;
}

// q [B, H, D] in T (strides qsb, qsh); kp / vp [P, ps, HKV, D] in KV;
// ks / vs [P, ps, HKV] float32 when KV is int8 (else null); part: the f32
// workspace, acc [B * H, nsplit, D] then (m, l) [B * H, nsplit, 2].
template <typename T, typename KV, int NACC, bool VEC16, bool BOUNDED>
__global__ void __launch_bounds__(kThreads)
paged_flash_decode_kernel(const T* __restrict__ q, const KV* __restrict__ kp,
                          const KV* __restrict__ vp,
                          const float* __restrict__ ks,
                          const float* __restrict__ vs,
                          const int* __restrict__ table,
                          const int* __restrict__ lens,
                          float* __restrict__ part, int B, int H, int HKV,
                          int D, int ps, int NP, int chunk, long long qsb,
                          long long qsh, float scale) {
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  constexpr int E = VEC16 ? 16 / sizeof(KV) : 1;   // elements per chunk
  extern __shared__ __align__(16) unsigned char smem[];
  const int g = H / HKV;
  const int RB = row_bytes(D, sizeof(KV));
  unsigned char* Kt = smem;                         // [2][kTT][RB]
  unsigned char* Vt = Kt + 2 * kTT * RB;            // [2][kTT][RB]
  float* KSt = reinterpret_cast<float*>(Vt + 2 * kTT * RB);  // [2][kTT]
  float* VSt = KSt + 2 * kTT;                       // [2][kTT]
  float* Qs = VSt + 2 * kTT;                        // [g][D], pre-scaled
  float* Ss = Qs + g * D;                           // [g][kTT]
  float* Ms = Ss + g * kTT;                         // running max, base 2
  float* Ls = Ms + g;                               // running sum
  float* As = Ls + g;                               // this tile's rescale
  float* Rs = As + g;                               // [kThreads]

  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int split = blockIdx.z;
  const int nsplit = gridDim.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const int len = max(0, min(lens[b], NP * ps));
  const int npages = (len + ps - 1) / ps;
  const int slot0 = split * chunk;
  const int slot1 = max(slot0, min(slot0 + chunk, NP));
  const int tok0 = slot0 * ps;
  const int cend = min(slot1 * ps, len);            // computed tokens' end
  const int ntc = cend > tok0 ? (cend - tok0 + kTT - 1) / kTT : 0;
  const int lend = BOUNDED ? min(slot1, npages) * ps : slot1 * ps;
  const int nt = BOUNDED ? ntc : (slot1 * ps - tok0 + kTT - 1) / kTT;

  const long long tok_stride = static_cast<long long>(HKV) * D;
  const int* trow = table + static_cast<long long>(b) * NP;

  // Stage tile it (tokens tok0 + it * kTT ...) into ring buffer it & 1;
  // tokens at or past lend are zero-filled without a read.
  auto load_tile = [&](int it) {
    const int buf = it & 1;
    const int t0 = tok0 + it * kTT;
    if constexpr (VEC16) {
      const int C = D / E;
      for (int idx = tid; idx < kTT * C; idx += kThreads) {
        const int t = idx / C;
        const int c = idx - t * C;
        const int tok = t0 + t;
        const bool ok = tok < lend;
        long long e0 = 0;
        if (ok) {
          const int slot = tok / ps;
          e0 = (static_cast<long long>(trow[slot]) * ps + (tok - slot * ps)) *
                   tok_stride + static_cast<long long>(kh) * D + c * E;
        }
        const int dst = (buf * kTT + t) * RB + c * 16;
        cp_async16(Kt + dst, kp + e0, ok);
        cp_async16(Vt + dst, vp + e0, ok);
      }
      if constexpr (kQuant) {
        for (int t = tid; t < kTT; t += kThreads) {
          const int tok = t0 + t;
          const bool ok = tok < lend;
          long long s0 = 0;
          if (ok) {
            const int slot = tok / ps;
            s0 = (static_cast<long long>(trow[slot]) * ps + (tok - slot * ps)) *
                     HKV + kh;
          }
          cp_async4(KSt + buf * kTT + t, ks + s0, ok);
          cp_async4(VSt + buf * kTT + t, vs + s0, ok);
        }
      }
    } else {
      for (int idx = tid; idx < kTT * D; idx += kThreads) {
        const int t = idx / D;
        const int d = idx - t * D;
        const int tok = t0 + t;
        KV kx{}, vx{};
        if (tok < lend) {
          const int slot = tok / ps;
          const long long e =
              (static_cast<long long>(trow[slot]) * ps + (tok - slot * ps)) *
                  tok_stride + static_cast<long long>(kh) * D + d;
          kx = kp[e];
          vx = vp[e];
        }
        reinterpret_cast<KV*>(Kt + (buf * kTT + t) * RB)[d] = kx;
        reinterpret_cast<KV*>(Vt + (buf * kTT + t) * RB)[d] = vx;
      }
      if constexpr (kQuant) {
        for (int t = tid; t < kTT; t += kThreads) {
          const int tok = t0 + t;
          float kx = 0.f, vx = 0.f;
          if (tok < lend) {
            const int slot = tok / ps;
            const long long s0 =
                (static_cast<long long>(trow[slot]) * ps + (tok - slot * ps)) *
                    HKV + kh;
            kx = ks[s0];
            vx = vs[s0];
          }
          KSt[buf * kTT + t] = kx;
          VSt[buf * kTT + t] = vx;
        }
      }
    }
  };

  if (nt > 0) load_tile(0);
  cp_async_commit();

  // q of the group's g heads, scaled so that scores come out in base 2
  const float qscale = scale * tc::kLog2e;
  for (int idx = tid; idx < g * D; idx += kThreads) {
    const int j = idx / D;
    const int d = idx - j * D;
    Qs[idx] = to_f32(q[b * qsb + (kh * g + j) * qsh + d]) * qscale;
  }
  for (int j = tid; j < g; j += kThreads) {
    Ms[j] = -INFINITY;
    Ls[j] = 0.f;
  }

  // scores: kTT * g (token, head) items (a multiple of 32, so a warp's
  // lanes agree on every loop trip), lpd lanes per item
  const int C = VEC16 ? D / E : D;
  int lpd = kThreads / (kTT * g);
  if (lpd > 32) lpd = 32;
  if (lpd < 1) lpd = 1;
  while (lpd > 1 && lpd / 2 >= C) lpd >>= 1;
  const int per = kThreads / lpd;
  const int li = tid % lpd;

  // P.V outputs: this thread's (head, column) pairs and token group
  const int NO = g * D;
  const int NOP = outputs_per_pass(NO);
  const int TPO = kThreads / NOP;
  const int tg = tid / NOP;
  const int ob = tid % NOP;
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;

  for (int it = 0; it < nt; ++it) {
    if (it + 1 < nt) {
      load_tile(it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                    // tile it (and q, m, l) in place
    if (BOUNDED || it < ntc) {          // !BOUNDED: dead tiles staged only
      const int buf = it & 1;
      const int ntok = min(kTT, cend - (tok0 + it * kTT));   // >= 1

      for (int item = tid / lpd; item < kTT * g; item += per) {
        const int t = item % kTT;
        const int j = item / kTT;
        const float* qj = Qs + j * D;
        const unsigned char* krow = Kt + (buf * kTT + t) * RB;
        float s = 0.f;
        for (int c = li; c < C; c += lpd) {
          if constexpr (VEC16) {
            const uint4 raw = *reinterpret_cast<const uint4*>(krow + c * 16);
            const KV* ke = reinterpret_cast<const KV*>(&raw);
#pragma unroll
            for (int e = 0; e < E; ++e) s += qj[c * E + e] * to_f32(ke[e]);
          } else {
            s += qj[c] * to_f32(reinterpret_cast<const KV*>(krow)[c]);
          }
        }
        for (int o = lpd / 2; o > 0; o >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, o);
        if (li == 0) {
          if constexpr (kQuant) s *= KSt[buf * kTT + t];
          Ss[j * kTT + t] = s;
        }
      }
      __syncthreads();

      // one warp per head: the tile's max and sum, lanes over tokens
      for (int j = warp; j < g; j += kWarps) {
        const bool live = lane < ntok;
        const float x = live ? Ss[j * kTT + lane] : -INFINITY;
        const float m_old = Ms[j];
        const float m_new = fmaxf(m_old, warp_max(x));
        const float base = m_new == -INFINITY ? 0.f : m_new;
        const float p = live ? exp2f(x - base) : 0.f;
        Ss[j * kTT + lane] = p;
        const float psum = warp_sum(p);
        if (lane == 0) {
          const float alpha = exp2f(m_old - base);  // m_old = -inf: 0
          As[j] = alpha;
          Ls[j] = Ls[j] * alpha + psum;
          Ms[j] = m_new;
        }
      }
      __syncthreads();

      // acc = acc * alpha + P.V over this thread's tokens
#pragma unroll
      for (int i = 0; i < NACC; ++i) {
        const int o = ob + NOP * i;
        if (o < NO) {
          const int j = o / D;
          const int d = o - j * D;
          float a = acc[i] * As[j];
          for (int t = tg; t < ntok; t += TPO) {
            float p = Ss[j * kTT + t];
            if constexpr (kQuant) p *= VSt[buf * kTT + t];
            a += p * to_f32(reinterpret_cast<const KV*>(
                              Vt + (buf * kTT + t) * RB)[d]);
          }
          acc[i] = a;
        }
      }
    }
    __syncthreads();                    // this buffer is free to refill
  }
  __syncthreads();                      // m, l in place when nt == 0

  const long long BH = static_cast<long long>(B) * H;
  float* pacc = part;
  float* pml = part + BH * nsplit * D;
  auto write = [&](int o, float a) {
    const int j = o / D;
    const int d = o - j * D;
    const long long row = static_cast<long long>(b) * H + kh * g + j;
    pacc[(row * nsplit + split) * D + d] = a;
  };
  if (TPO > 1) {                        // NO < kThreads: one pass, NACC = 1
    Rs[tid] = acc[0];
    __syncthreads();
    if (tg == 0 && ob < NO) {
      float a = Rs[ob];
      for (int u = 1; u < TPO; ++u) a += Rs[u * NOP + ob];
      write(ob, a);
    }
  } else {
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int o = ob + NOP * i;
      if (o < NO) write(o, acc[i]);
    }
  }
  for (int j = tid; j < g; j += kThreads) {
    const long long row = static_cast<long long>(b) * H + kh * g + j;
    pml[(row * nsplit + split) * 2] = Ms[j];
    pml[(row * nsplit + split) * 2 + 1] = Ls[j];
  }
}

// One warp per (row, head): the splits' partials merged in split order,
// o = sum_s w_s acc_s / sum_s w_s l_s with w_s = 2^(m_s - max m); an empty
// row (every l_s = 0) writes zeros.  KV only names the pools' type, so a
// profile tells K4's merge from K3's.
template <typename T, typename KV>
__global__ void __launch_bounds__(kThreads)
paged_decode_merge_kernel(const float* __restrict__ part, T* __restrict__ o,
                          int BH, int D, int nsplit) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= BH) return;
  const float* acc = part + static_cast<long long>(row) * nsplit * D;
  const float* ml = part + static_cast<long long>(BH) * nsplit * D +
                    static_cast<long long>(row) * nsplit * 2;
  float m = -INFINITY;
  for (int s = 0; s < nsplit; ++s) m = fmaxf(m, ml[2 * s]);
  const float base = m == -INFINITY ? 0.f : m;
  float l = 0.f;
  for (int s = 0; s < nsplit; ++s) l += exp2f(ml[2 * s] - base) * ml[2 * s + 1];
  const float inv = l > 0.f ? 1.f / l : 0.f;
  for (int d = lane; d < D; d += 32) {
    float a = 0.f;
    for (int s = 0; s < nsplit; ++s)
      a += exp2f(ml[2 * s] - base) * acc[s * D + d];
    o[static_cast<long long>(row) * D + d] = from_f32<T>(a * inv);
  }
}

template <typename T, typename KV, int NACC>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const float* ks, const float* vs, const int* table,
                   const int* lens, void* o, float* part, int B, int H,
                   int HKV, int D, int ps, int NP, int nsplit, long long qsb,
                   long long qsh, float scale, bool bounded,
                   cudaStream_t stream) {
  const bool vec16 = (D * sizeof(KV)) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(kp) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(vp) % 16 == 0;
  auto kernel =
      bounded
          ? (vec16 ? paged_flash_decode_kernel<T, KV, NACC, true, true>
                   : paged_flash_decode_kernel<T, KV, NACC, false, true>)
          : (vec16 ? paged_flash_decode_kernel<T, KV, NACC, true, false>
                   : paged_flash_decode_kernel<T, KV, NACC, false, false>);
  const int g = H / HKV;
  const size_t smem = smem_bytes(D, sizeof(KV), g);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int chunk = (NP + nsplit - 1) / nsplit;
  dim3 grid(B, HKV, nsplit);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(kp),
      static_cast<const KV*>(vp), ks, vs, table, lens, part, B, H, HKV, D,
      ps, NP, chunk, qsb, qsh, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int BH = B * H;
  paged_decode_merge_kernel<T, KV><<<(BH + kWarps - 1) / kWarps, kThreads, 0,
                                 stream>>>(part, static_cast<T*>(o), BH, D,
                                           nsplit);
  return cudaGetLastError();
}

// Checks the shape limits every entry shares, then picks NACC, the output
// passes per thread (g * D <= NACC * kThreads).  part: the f32 workspace
// of B * H * nsplit * (D + 2) floats.  Returns the launches' cudaError_t.
template <typename T, typename KV>
cudaError_t dispatch(const void* q, const void* kp, const void* vp,
                     const float* ks, const float* vs, const void* table,
                     const void* lens, void* o, void* part, int B, int H,
                     int HKV, int D, int ps, int NP, int nsplit,
                     long long qsb, long long qsh, float scale, int bounded,
                     void* stream) {
  if (B < 1 || HKV < 1 || H % HKV != 0 || H / HKV > 32 || D < 1 || D > 256 ||
      ps < 1 || NP < 1 || nsplit < 1 || nsplit > NP)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(table);
  const int* ln = static_cast<const int*>(lens);
  float* pt = static_cast<float*>(part);
  const bool bd = bounded != 0;
  const int NO = (H / HKV) * D;
  if (NO <= kThreads)
    return launch<T, KV, 1>(q, kp, vp, ks, vs, tb, ln, o, pt, B, H, HKV, D,
                            ps, NP, nsplit, qsb, qsh, scale, bd, s);
  if (NO <= 4 * kThreads)
    return launch<T, KV, 4>(q, kp, vp, ks, vs, tb, ln, o, pt, B, H, HKV, D,
                            ps, NP, nsplit, qsb, qsh, scale, bd, s);
  if (NO <= 16 * kThreads)
    return launch<T, KV, 16>(q, kp, vp, ks, vs, tb, ln, o, pt, B, H, HKV, D,
                             ps, NP, nsplit, qsb, qsh, scale, bd, s);
  return launch<T, KV, 64>(q, kp, vp, ks, vs, tb, ln, o, pt, B, H, HKV, D,
                           ps, NP, nsplit, qsb, qsh, scale, bd, s);
}

}  // namespace paged
}  // namespace ptt
