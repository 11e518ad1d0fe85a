// K3: length-bounded split-K paged flash decode, written by hand for
// Hopper (sm_90a), and K5a, its full-sweep twin (bounded = 0).
//
// K3 replaces the Pallas TPU kernel paddle_tpu/ops/paged_attention.py
// (_paged_flash_pallas -> _paged_flash_kernel, with _accum_page and the
// _bounded_page_map clamp); K5a replaces the legacy full-sweep
// _paged_pallas -> _paged_kernel, which visits every table page.  The
// pools are in q's dtype, or bf16 / f16 under an f32 q (a bf16 Llama's
// rotated queries are f32 over its bf16 cache, as in the TPU package:
// the pages are widened to f32 where they are used, never in memory).
// The kernel body, what bounds it and its design are in
// paged_flash_decode.cuh; the int8 twins K4 / K5b are in
// paged_flash_decode_q.cu.
#include "paged_flash_decode.cuh"

namespace {

template <typename T, typename KV>
cudaError_t run(const void* q, const void* k_pages, const void* v_pages,
                const void* table, const void* lens, void* o, void* workspace,
                int B, int H, int HKV, int D, int ps, int NP, int nsplit,
                long long qsb, long long qsh, float scale, int bounded,
                void* stream) {
  return ptt::paged::dispatch<T, KV>(q, k_pages, v_pages, nullptr, nullptr,
                                     table, lens, o, workspace, B, H, HKV, D,
                                     ps, NP, nsplit, qsb, qsh, scale, bounded,
                                     stream);
}

}  // namespace

// q: [B, H, D] with element strides (qsb, qsh), head dim unit-stride, of
// dtype code `dtype`.  k_pages / v_pages: contiguous [P, ps, HKV, D] of
// dtype code `kv_dtype`: q's, or bf16 / f16 when q is f32 (any other
// pairing returns cudaErrorInvalidValue).  table: contiguous int32
// [B, NP]; lens: int32 [B]; o: contiguous [B, H, D] in q's dtype;
// workspace: float32, B * H * nsplit * (D + 2) elements, for the nsplit
// splits' partials.  bounded: 1 for K3 (a split loads only the pages below
// ceil(len / ps)), 0 for K5a (every table page is staged).  Returns the
// cudaError_t of the launches (0 on success).
extern "C" int ptt_paged_flash_decode(const void* q, const void* k_pages,
                                      const void* v_pages, const void* table,
                                      const void* lens, void* o,
                                      void* workspace, int dtype,
                                      int kv_dtype, int B, int H, int HKV,
                                      int D, int ps, int NP, int nsplit,
                                      long long qsb, long long qsh,
                                      float scale, int bounded, void* stream) {
  cudaError_t err = cudaErrorInvalidValue;
  if (kv_dtype == dtype) {
    PTT_DISPATCH_DTYPE(dtype, {
      err = run<scalar_t, scalar_t>(q, k_pages, v_pages, table, lens, o,
                                    workspace, B, H, HKV, D, ps, NP, nsplit,
                                    qsb, qsh, scale, bounded, stream);
    });
  } else if (dtype == ptt::kF32 && kv_dtype == ptt::kBF16) {
    err = run<float, __nv_bfloat16>(q, k_pages, v_pages, table, lens, o,
                                    workspace, B, H, HKV, D, ps, NP, nsplit,
                                    qsb, qsh, scale, bounded, stream);
  } else if (dtype == ptt::kF32 && kv_dtype == ptt::kF16) {
    err = run<float, __half>(q, k_pages, v_pages, table, lens, o, workspace,
                             B, H, HKV, D, ps, NP, nsplit, qsb, qsh, scale,
                             bounded, stream);
  }
  return static_cast<int>(err);
}
