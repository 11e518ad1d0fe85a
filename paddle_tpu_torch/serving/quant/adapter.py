"""QuantizedGPTAdapter — int8 paged KV pools for the serving engine
(counterpart of ``paddle_tpu/serving/quant/adapter.py``).

Same contract as :class:`~paddle_tpu_torch.serving.adapter.GPTAdapter`,
but the KV state is four tensors instead of two:

- ``kp, vp``: int8 page pools ``[L, P, ps, h, d]`` — half the bf16 bytes,
  a quarter of f32;
- ``k_scales, v_scales``: float32 scale pools ``[L, P, ps, h]`` — one
  absmax scale per (page slot, kv head), addressed by the SAME page table.

The ``served_q`` / ``served_chunk_q`` cache variants of
:class:`GPTDecoderLayer` round K/V onto the int8 grid on the way into
every pool write (``ops.paged_attention.paged_table_*_write_quant``) and
attend through ``paged_attention_quantized`` / ``paged_chunk_attend_quant``
(K4 on the card), which dequantize inside the kernel; speculative verify
and chunked prefill ride the inherited ``verify`` / ``prefill_chunk``.  Prefill attends the full-precision prompt; only the cache is
quantized.  The pools are written in place.
"""

from __future__ import annotations

import torch

from ..adapter import GPTAdapter


class QuantizedGPTAdapter(GPTAdapter):
    """``ServingEngine(kv_dtype="int8")`` builds one of these."""

    tag = "served_q"
    chunk_tag = "served_chunk_q"
    n_pools = 4
    kv_dtype = "int8"

    def init_pools(self, num_pages):
        """Zeroed ``(kp, vp, k_scales, v_scales)``: int8 payload pools
        ``[L, P, ps, h, d]`` and float32 scale pools ``[L, P, ps, h]``."""
        shape = (self.num_layers, int(num_pages), self.page_size,
                 self.num_kv_heads, self.head_dim)
        payload = [torch.zeros(shape, dtype=torch.int8, device=self.device)
                   for _ in range(2)]
        scales = [torch.zeros(shape[:-1], dtype=torch.float32,
                              device=self.device) for _ in range(2)]
        return (*payload, *scales)

    def page_bytes(self):
        """One page across all layers, K and V: the int8 payload (d bytes
        per position per head) and its float32 scale (4 bytes) —
        (d + 4) / (2 d) of the bf16 cost."""
        return (2 * self.num_layers * self.page_size * self.num_kv_heads
                * (self.head_dim + 4))

    def pool_owners(self):
        """int8 payload pools and float32 scale pools get separate ledger
        owners: the scale pools are real device residency."""
        return (("kv.pages", (0, 1)), ("kv.scales", (2, 3)))

    def _layer_caches(self, tag, pools, table, lens):
        kp, vp, ks, vs = pools
        return [(tag, kp[i], vp[i], ks[i], vs[i], table, lens)
                for i in range(self.num_layers)]
