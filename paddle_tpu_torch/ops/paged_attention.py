"""Paged KV-cache attention for the serving engine (counterpart of
``paddle_tpu/ops/paged_attention.py``, its table-addressed serving part).

The engine keeps ONE global page pool ``[P, ps, HKV, D]`` per layer for K
and one for V, shared by every slot through a page table ``[B, NP]``
(int32) and per-slot lengths ``seq_lens [B]`` (int32).

- :func:`paged_attention` — one decode token per row against the pools.
  A CPU tensor takes the plain version :func:`paged_attention_ref`; a CUDA
  tensor launches the hand-written kernel ``csrc/paged_flash_decode.cu``
  (the port of the TPU's ``_paged_flash_kernel``: the sweep stops at each
  row's last valid page, GQA grouped in the kernel), or raises.
- :func:`paged_table_prefill_write` / :func:`paged_table_token_write` —
  the pool writes, plain in-place torch indexing.  JAX donated the pools
  and rebuilt them with scatters; here the pools are updated IN PLACE and
  returned for the caller's convenience.

``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

NEG_INF = -1e30

#: number of times the CUDA kernel was launched in this process
LAUNCHES = 0


def _last_page(seq_len, page_size):
    """Index of the last page a row's sweep must visit (>= 0, so empty
    rows still have a step to finalize on)."""
    return torch.clamp((seq_len + page_size - 1) // page_size - 1, min=0)


def _gathered_attend(q, k, v, seq_lens, scale):
    """q ``[B, H, D]`` against gathered k/v ``[B, T, HKV, D]`` masked by
    ``seq_lens``.  GQA as a grouped einsum over ``[HKV, g]``: query head
    ``k * g + j`` attends kv head ``k`` (the ``repeat`` convention)."""
    B, H, D = q.shape
    T, HKV = k.shape[1], k.shape[2]
    g = H // HKV
    qg = q.reshape(B, HKV, g, D).float()
    s = torch.einsum("bkgd,btkd->bkgt", qg, k.float()) * scale
    pos = torch.arange(T, device=q.device)[None, None, None, :]
    s = s.masked_fill(pos >= seq_lens.to(q.device)[:, None, None, None].long(),
                      NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p, v.float())
    return out.reshape(B, H, D).to(q.dtype)


def paged_attention_ref(q, k_pages, v_pages, page_table, seq_lens, scale=None):
    """Dense-gather plain version of :func:`paged_attention`, on any device.

    It follows the kernel where the TPU package's oracle of the same name
    differs: a row with ``seq_lens == 0`` gives zeros (the oracle gives the
    mean of V, an all-masked softmax; every paged kernel writes zeros).
    Lengths past ``NP * ps`` clamp to the table."""
    B, H, D = q.shape
    HKV, ps = k_pages.shape[2], k_pages.shape[1]
    NP = page_table.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    idx = page_table.long()
    k = k_pages[idx].reshape(B, NP * ps, HKV, D)
    v = v_pages[idx].reshape(B, NP * ps, HKV, D)
    out = _gathered_attend(q, k, v, seq_lens, scale)
    empty = (seq_lens.to(q.device) <= 0)[:, None, None]
    return out.masked_fill(empty, 0.0)


def paged_attention(q, k_pages, v_pages, page_table, seq_lens, scale=None):
    """Decode attention over a paged KV cache.

    q ``[B, H, D]`` (head dim unit-stride; other strides free), pools
    ``[P, ps, HKV, D]``, ``page_table [B, NP]`` int32, ``seq_lens [B]``
    int32; output ``[B, H, D]`` in q's dtype.  Every table entry a row's
    sweep reaches must index a valid page; slots past the row's length are
    never read."""
    B, H, D = q.shape
    if H % k_pages.shape[2]:
        raise ValueError(f"q heads {H} not a multiple of kv heads "
                         f"{k_pages.shape[2]}")
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, page_table, seq_lens,
                                   scale)
    _check_cuda_args(q, k_pages, v_pages, page_table, seq_lens)
    P, ps, HKV, _ = k_pages.shape
    NP = page_table.shape[1]
    o = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.ptt_paged_flash_decode(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), seq_lens.data_ptr(), o.data_ptr(),
            _build.dtype_code(q), B, H, HKV, D, ps, NP, q.stride(0),
            q.stride(1), scale, _build.stream_handle(q))
    _build.check(err, "paged_flash_decode")
    global LAUNCHES
    LAUNCHES += 1
    return o


def _check_cuda_args(q, k_pages, v_pages, page_table, seq_lens):
    if q.device.type != "cuda":
        raise NotImplementedError(
            f"paged attention runs on cuda or cpu tensors, got {q.device}")
    _build.check_no_grad(q, k_pages, v_pages)
    for name, x in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("seq_lens", seq_lens)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(f"pool dtypes {k_pages.dtype}/{v_pages.dtype} differ "
                        f"from q's {q.dtype}")
    if k_pages.shape != v_pages.shape or k_pages.shape[3] != q.shape[2]:
        raise ValueError(f"pools {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if page_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("page_table and seq_lens must be int32")
    if page_table.shape[0] != q.shape[0] or seq_lens.shape != (q.shape[0],):
        raise ValueError("page_table / seq_lens rows must match q's batch")
    if q.stride(2) != 1:
        raise ValueError("q must be unit-stride in head_dim")
    if q.shape[1] // k_pages.shape[2] > 32 or q.shape[2] > 256:
        raise NotImplementedError("the paged decode kernel takes at most 32 "
                                  "query heads per kv head and head_dim <= 256")


def _lib():
    lib = _build.load("paged_flash_decode")
    fn = lib.ptt_paged_flash_decode
    if fn.argtypes is None:
        P = ctypes.c_void_p
        I = ctypes.c_int
        L = ctypes.c_longlong
        fn.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I, I, L, L,
                       ctypes.c_float, P]
        fn.restype = I
    return lib


# ------------------------------------------------- serving-engine pool writes
def paged_table_prefill_write(pool, kv, table):
    """Write whole (right-padded) prompts into their table pages at
    position 0, in place.

    pool ``[P, ps, *rest]``; kv ``[B, S, *rest]``; table ``[B, NP]``.  Row
    b's S tokens land in pages ``table[b, :ceil(S / ps)]``; the pad tokens
    go to pages that per-slot ``seq_lens`` keeps invisible, or to the
    engine's scratch page (several lanes may write it: harmless junk)."""
    B, S = kv.shape[:2]
    rest = kv.shape[2:]
    ps = pool.shape[1]
    pad = (ps - S % ps) % ps
    if pad:
        kv = torch.cat([kv, kv.new_zeros((B, pad) + rest)], dim=1)
    nc = kv.shape[1] // ps
    idx = table[:, :nc].reshape(-1).long()
    pool[idx] = kv.reshape((B * nc, ps) + rest).to(pool.dtype)
    return pool


def paged_table_token_write(pool, tok, table, lens):
    """Write one token's K or V per slot at the slot's own position, in
    place: slot b's token lands in page ``table[b, lens[b] // ps]``, offset
    ``lens[b] % ps``.  Inactive lanes (length 0, all-scratch table) all
    write position 0 of the scratch page; the indices collide and the
    junk is never attended, as in the TPU package.  A position past the
    table clamps to its last page, as JAX's gather does."""
    B = tok.shape[0]
    ps = pool.shape[1]
    lens = lens.long()
    col = torch.clamp(lens // ps, max=table.shape[1] - 1)
    rows = torch.arange(B, device=table.device)
    pages = table[rows, col].long()
    pool[pages, lens % ps] = tok.to(pool.dtype)
    return pool
