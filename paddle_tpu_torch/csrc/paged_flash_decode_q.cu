// K4: length-bounded split-K paged flash decode over int8 page pools with
// the dequantization fused into the loads, written by hand for Hopper
// (sm_90a), and K5b, its full-sweep twin (bounded = 0).
//
// K4 replaces the Pallas TPU kernel paddle_tpu/ops/paged_attention.py
// (_paged_q_flash_pallas -> _paged_q_flash_kernel: K3 with each int8 page
// tile multiplied by its [ps, 1] scale column right after the load); K5b
// replaces the legacy full-sweep _paged_q_pallas -> _paged_q_kernel.
//
// What bounds it on this card: bytes, as for K3, but a valid key costs
// D + 4 bytes per kv head for K and again for V (int8 payload and its
// float32 scale) instead of 2 D in bf16.  The design is K3's
// (paged_flash_decode.cuh): a tile's int8 rows (16 values per 16-byte
// copy) and its scales (scale of (page, t, kh) at page * ps * HKV + t *
// HKV + kh) are staged by cp.async as they are stored; a score is the
// int8 row's dot product with q times the row's K scale, and a
// probability is multiplied by the row's V scale before it weights the
// int8 V row.
#include "paged_flash_decode.cuh"

// q: [B, H, D] in f32 / f16 / bf16 with element strides (qsb, qsh), head
// dim unit-stride.  k_pages / v_pages: contiguous int8 [P, ps, HKV, D];
// k_scales / v_scales: contiguous float32 [P, ps, HKV]; table: contiguous
// int32 [B, NP]; lens: int32 [B]; o: contiguous [B, H, D] in q's dtype;
// workspace: float32, B * H * nsplit * (D + 2) elements.  bounded: 1 for
// K4, 0 for K5b.  Returns the cudaError_t of the launches.
extern "C" int ptt_paged_flash_decode_q(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* table,
    const void* lens, void* o, void* workspace, int dtype, int B, int H,
    int HKV, int D, int ps, int NP, int nsplit, long long qsb,
    long long qsh, float scale, int bounded, void* stream) {
  const float* ks = static_cast<const float*>(k_scales);
  const float* vs = static_cast<const float*>(v_scales);
  cudaError_t err = cudaSuccess;
  PTT_DISPATCH_DTYPE(dtype, {
    err = ptt::paged::dispatch<scalar_t, int8_t>(
        q, k_pages, v_pages, ks, vs, table, lens, o, workspace, B, H, HKV, D,
        ps, NP, nsplit, qsb, qsh, scale, bounded, stream);
  });
  return static_cast<int>(err);
}
