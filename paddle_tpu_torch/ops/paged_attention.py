"""Paged KV-cache attention for the serving engine (counterpart of
``paddle_tpu/ops/paged_attention.py``, its table-addressed serving part and
its int8 section).

The engine keeps ONE global page pool ``[P, ps, HKV, D]`` per layer for K
and one for V, shared by every slot through a page table ``[B, NP]``
(int32) and per-slot lengths ``seq_lens [B]`` (int32).

- :func:`paged_attention` — one decode token per row against the pools.
  A CPU tensor takes the plain version :func:`paged_attention_ref`; a CUDA
  tensor launches the hand-written kernel ``csrc/paged_flash_decode.cu``
  (K3, the port of the TPU's ``_paged_flash_kernel``: each row's table
  slots split over :func:`_splits` blocks, each stopping at the row's last
  valid page, merged by a second kernel; GQA grouped in the kernel), or
  raises.
- :func:`paged_attention_quantized` — the same over int8 pools with
  parallel float32 scale pools ``[P, ps, HKV]``: the plain version
  :func:`paged_attention_quantized_ref` on the CPU, the hand-written K4
  (``csrc/paged_flash_decode_q.cu``, dequantization fused into the page
  loads) on the card.
- :func:`_paged_full_sweep` / :func:`_paged_q_full_sweep` — K5a / K5b, the
  full-sweep twins of K3 / K4 (the TPU package's ``_paged_pallas`` /
  ``_paged_q_pallas``): same function, every table page staged.  Only
  tests call them.
- :func:`paged_table_prefill_write` / :func:`paged_table_token_write` /
  :func:`paged_table_chunk_write` and their quantizing twins — the pool
  writes, plain in-place torch indexing.  JAX donated the pools and
  rebuilt them with scatters; here the pools are updated IN PLACE and
  returned for the caller's convenience.
- :func:`paged_chunk_attend` / :func:`paged_chunk_attend_quant` — C query
  positions per slot (speculative verify, chunked prefill), each with its
  own length: one K3 / K4 launch over a ``[B*C]``-row expansion on the
  card, one gather per slot on the CPU.
- The lock-step helpers of ``generate(cache_impl="paged")``:
  :func:`paged_prefill_write`, :func:`paged_token_write`,
  :func:`paged_decode_attend` (K3 over an identity table on the card) and
  :class:`PagedKVCache`.

``LAUNCHES`` (K3), ``QUANT_LAUNCHES`` (K4), ``FULL_SWEEP_LAUNCHES`` (K5a)
and ``QUANT_FULL_SWEEP_LAUNCHES`` (K5b) count kernel launches, one per
call (a call launches the split kernel and its merge).
``DECODE_ATTEND_LAUNCHES``, ``CHUNK_LAUNCHES`` and ``QUANT_CHUNK_LAUNCHES``
count the K3 / K3 / K4 launches made through :func:`paged_decode_attend`,
:func:`paged_chunk_attend` and :func:`paged_chunk_attend_quant` (each such
launch is also in ``LAUNCHES`` / ``QUANT_LAUNCHES``).
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .quant import quantize_absmax

NEG_INF = -1e30
#: blocks the split-K decode aims for: four per SM of the H100's 132
_TARGET_BLOCKS = 4 * 132
#: the pool dtypes K3 takes under an f32 q (a bf16 Llama's rotated queries
#: over its bf16 cache); under a bf16 / f16 q the pools are in q's dtype
_F32_Q_POOLS = (torch.float32, torch.bfloat16, torch.float16)

#: launches of each CUDA kernel in this process: K3, K4, K5a, K5b
LAUNCHES = 0
QUANT_LAUNCHES = 0
FULL_SWEEP_LAUNCHES = 0
QUANT_FULL_SWEEP_LAUNCHES = 0
#: the K3 / K4 launches above made through the lock-step and chunk paths
DECODE_ATTEND_LAUNCHES = 0
CHUNK_LAUNCHES = 0
QUANT_CHUNK_LAUNCHES = 0


def _last_page(seq_len, page_size):
    """Index of the last page a row's sweep must visit (>= 0, so empty
    rows still have a step to finalize on)."""
    return torch.clamp((seq_len + page_size - 1) // page_size - 1, min=0)


def _gathered_attend(q, k, v, seq_lens, scale):
    """q ``[B, H, D]`` against gathered k/v ``[B, T, HKV, D]`` masked by
    ``seq_lens``.  GQA as a grouped einsum over ``[HKV, g]``: query head
    ``k * g + j`` attends kv head ``k`` (the ``repeat`` convention).  The
    math runs in f32 and the output takes q's dtype, so an f32 q over bf16
    pages gives f32, as the TPU package's ``astype(q.dtype)`` does.  Rows
    with ``seq_lens == 0`` give zeros, as every kernel does (the TPU
    package's oracles give the mean of V, an all-masked softmax)."""
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
    empty = (seq_lens.to(q.device) <= 0)[:, None, None]
    return out.reshape(B, H, D).to(q.dtype).masked_fill(empty, 0.0)


def _gathered_chunk_attend(q, k, v, lens2, scale):
    """Chunked twin of :func:`_gathered_attend`, the plain version of the
    chunk paths: q ``[B, C, H, D]`` against gathered k/v ``[B, T, HKV,
    D]``, position (b, t) masked to its own valid length ``lens2[b, t]``
    (>= 1).  Each slot's pages are gathered once for all C positions."""
    B, C, H, D = q.shape
    T, HKV = k.shape[1], k.shape[2]
    g = H // HKV
    qg = q.reshape(B, C, HKV, g, D).float()
    s = torch.einsum("bckgd,btkd->bckgt", qg, k.float()) * scale
    pos = torch.arange(T, device=q.device)[None, None, None, None, :]
    s = s.masked_fill(pos >= lens2.to(q.device)[:, :, None, None, None].long(),
                      NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bckgt,btkd->bckgd", p, v.float())
    return out.reshape(B, C, H, D).to(q.dtype)


def paged_attention_ref(q, k_pages, v_pages, page_table, seq_lens, scale=None):
    """Dense-gather plain version of :func:`paged_attention`, on any device.

    It follows the kernel where the TPU package's oracle of the same name
    differs: a row with ``seq_lens == 0`` gives zeros.  Lengths past
    ``NP * ps`` clamp to the table."""
    B, H, D = q.shape
    HKV, ps = k_pages.shape[2], k_pages.shape[1]
    NP = page_table.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    idx = page_table.long()
    k = k_pages[idx].reshape(B, NP * ps, HKV, D)
    v = v_pages[idx].reshape(B, NP * ps, HKV, D)
    return _gathered_attend(q, k, v, seq_lens, scale)


def paged_attention(q, k_pages, v_pages, page_table, seq_lens, scale=None):
    """Decode attention over a paged KV cache.

    q ``[B, H, D]`` (head dim unit-stride; other strides free), pools
    ``[P, ps, HKV, D]`` in q's dtype (or bf16 / f16 under an f32 q),
    ``page_table [B, NP]`` int32, ``seq_lens [B]`` int32; output
    ``[B, H, D]`` in q's dtype.  Every table entry a row's sweep reaches
    must index a valid page; slots past the row's length are never read."""
    scale = _check_heads(q, k_pages, scale)
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, page_table, seq_lens,
                                   scale)
    global LAUNCHES
    o = _launch(q, k_pages, v_pages, None, None, page_table, seq_lens, scale,
                bounded=True)
    LAUNCHES += 1
    return o


def _paged_full_sweep(q, k_pages, v_pages, page_table, seq_lens, scale=None):
    """K5a: :func:`paged_attention`'s function with the legacy full sweep
    (the TPU package's ``_paged_pallas``): every one of a row's table pages
    is staged, compute stops at its length.  Only tests call it; its plain
    version is :func:`paged_attention_ref`."""
    scale = _check_heads(q, k_pages, scale)
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, page_table, seq_lens,
                                   scale)
    global FULL_SWEEP_LAUNCHES
    o = _launch(q, k_pages, v_pages, None, None, page_table, seq_lens, scale,
                bounded=False)
    FULL_SWEEP_LAUNCHES += 1
    return o


def _splits(B, HKV, NP):
    """Splits of a row's ``NP`` table slots for the decode kernels: enough
    blocks of (row, kv head, split) to reach ``_TARGET_BLOCKS``, each
    split a whole number of slots and none empty of slots.  The lengths
    play no part (they stay on the device), so a decode step keeps one
    grid whatever its rows hold."""
    want = min(NP, max(1, -(-_TARGET_BLOCKS // (B * HKV))))
    chunk = NP // want                  # at least `want` splits
    return -(-NP // chunk)


def _check_heads(q, k_pages, scale):
    """The GQA rule every entry shares; returns the softmax scale."""
    H, D = q.shape[1], q.shape[2]
    if H % k_pages.shape[2]:
        raise ValueError(f"q heads {H} not a multiple of kv heads "
                         f"{k_pages.shape[2]}")
    return float(scale) if scale is not None else 1.0 / math.sqrt(D)


def _launch(q, k_pages, v_pages, k_scales, v_scales, page_table, seq_lens,
            scale, bounded):
    """Check the arguments and launch K3 / K5a (no scales) or K4 / K5b
    (int8 pools with their scale pools) on q's stream, with the f32
    workspace of the splits' partials."""
    _check_cuda_args(q, k_pages, v_pages, k_scales, v_scales, page_table,
                     seq_lens)
    B, H, D = q.shape
    P, ps, HKV, _ = k_pages.shape
    NP = page_table.shape[1]
    nsplit = _splits(B, HKV, NP)
    o = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    work = torch.empty(B * H * nsplit * (D + 2), dtype=torch.float32,
                       device=q.device)
    if k_scales is None:
        # the pools' own dtype code: q's, or bf16 / f16 under an f32 q
        name, scales, codes = "paged_flash_decode", (), (
            _build.dtype_code(q), _build.dtype_code(k_pages))
    else:
        name, scales, codes = "paged_flash_decode_q", (
            k_scales.data_ptr(), v_scales.data_ptr()), (_build.dtype_code(q),)
    fn = getattr(_lib(name), "ptt_" + name)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), *scales,
                 page_table.data_ptr(), seq_lens.data_ptr(), o.data_ptr(),
                 work.data_ptr(), *codes, B, H, HKV, D, ps, NP, nsplit,
                 q.stride(0), q.stride(1), scale, int(bounded),
                 _build.stream_handle(q))
    _build.check(err, name)
    _report_cost(q, k_pages, k_scales, page_table, seq_lens)
    return o


def _report_cost(q, k_pages, k_scales, page_table, seq_lens):
    """K3 / K4's analytic cost for the perf table's counted step (a
    ctypes launch is invisible to the flop counter): 4 * D operations per
    visible key per query head; q read and o written once, each page a
    row's sweep reaches read once (int8 pages with their scales).  Reads
    the lengths from the card: only ever off the dispatch path."""
    from ..observability import perf as _perf

    if not _perf.counting_kernels():
        return
    B, H, D = q.shape
    P, ps, HKV, _ = k_pages.shape
    NP = page_table.shape[1]
    lens = torch.clamp(seq_lens.long(), 0, NP * ps).cpu()
    table = page_table.cpu()
    pages = set()
    for b in range(B):
        pages.update(table[b, :-(-int(lens[b]) // ps)].tolist())
    per_page = 2 * ps * HKV * D * k_pages.element_size() \
        + (2 * ps * HKV * 4 if k_scales is not None else 0)
    _perf.kernel_cost(4 * D * H * int(lens.sum()),
                      2 * B * H * D * q.element_size()
                      + len(pages) * per_page)


def _check_cuda_args(q, k_pages, v_pages, k_scales, v_scales, page_table,
                     seq_lens):
    if q.device.type != "cuda":
        raise NotImplementedError(
            f"paged attention runs on cuda or cpu tensors, got {q.device}")
    _build.check_no_grad(q, k_pages, v_pages)
    quant = k_scales is not None
    named = [("k_pages", k_pages), ("v_pages", v_pages),
             ("page_table", page_table), ("seq_lens", seq_lens)]
    if quant:
        named += [("k_scales", k_scales), ("v_scales", v_scales)]
    for name, x in named:
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if quant:
        want = (torch.int8,)
    elif q.dtype == torch.float32:
        want = _F32_Q_POOLS
    else:
        want = (q.dtype,)
    if k_pages.dtype != v_pages.dtype or k_pages.dtype not in want:
        raise TypeError(f"pool dtypes {k_pages.dtype}/{v_pages.dtype} under "
                        f"a {q.dtype} q: this kernel takes "
                        f"{' or '.join(map(str, want))}")
    if k_pages.shape != v_pages.shape or k_pages.shape[3] != q.shape[2]:
        raise ValueError(f"pools {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if quant:
        if k_scales.dtype != torch.float32 or v_scales.dtype != torch.float32:
            raise TypeError("k_scales and v_scales must be float32")
        if k_scales.shape != k_pages.shape[:3] \
                or v_scales.shape != k_pages.shape[:3]:
            raise ValueError(f"scale pools {tuple(k_scales.shape)} / "
                             f"{tuple(v_scales.shape)} do not match the pools' "
                             f"{tuple(k_pages.shape[:3])}")
    if page_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("page_table and seq_lens must be int32")
    if page_table.shape[0] != q.shape[0] or seq_lens.shape != (q.shape[0],):
        raise ValueError("page_table / seq_lens rows must match q's batch")
    if q.stride(2) != 1:
        raise ValueError("q must be unit-stride in head_dim")
    if q.shape[1] // k_pages.shape[2] > 32 or q.shape[2] > 256:
        raise NotImplementedError("the paged decode kernels take at most 32 "
                                  "query heads per kv head and head_dim <= 256")


# (pointer, int) arguments that lead each entry; then both take
# qsb, qsh | scale | bounded | stream
_N_ARGS = {
    # q, k, v, table, lens, o, workspace | dtype, kv_dtype, B, H, HKV, D,
    # ps, NP, nsplit
    "paged_flash_decode": (7, 9),
    # q, k, v, k_scales, v_scales, table, lens, o, workspace | dtype, B, H,
    # HKV, D, ps, NP, nsplit
    "paged_flash_decode_q": (9, 8),
}


def _lib(name):
    lib = _build.load(name)
    fn = getattr(lib, "ptt_" + name)
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        n_ptrs, n_ints = _N_ARGS[name]
        fn.argtypes = [P] * n_ptrs + [I] * n_ints + [L, L, ctypes.c_float,
                                                     I, P]
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


def paged_table_chunk_write(pool, kv, table, lens):
    """Write a CHUNK of C tokens per slot at positions ``lens[b] ..
    lens[b] + C - 1``, in place (speculative verify: the last sampled token
    plus C - 1 drafts; chunked prefill: the next C prompt tokens).

    pool ``[P, ps, *rest]``; kv ``[B, C, *rest]``; table ``[B, NP]``; lens
    ``[B]``.  Lanes past the table's reach (``pos >= NP * ps``: pad lanes
    of a slot near the model cap) are DROPPED, the contract of JAX's
    ``mode="drop"`` scatter; a clamp would make them collide with the
    chunk's own write of the last position, and a scatter with duplicate
    indices has no defined winner.  (JAX marks them with page -1, which
    its index normalization wraps to the pool's last row, the engine's
    scratch page, before the drop applies.)  torch has no drop mode, and a boolean mask
    would sync the host, so a dropped lane is sent where the clamp puts it
    (the slot's last table position) carrying the bytes that position ends
    up with anyway: those of the chunk's own lane for it, or, when the
    whole chunk lies past the table, the pool's current bytes.  Every
    writer of that position then writes the same bytes.  In-range junk
    lanes (rejected drafts, prefill pad) need no undo: they sit past the
    slot's valid length, and the next write at the rolled-back length
    overwrites them."""
    B, C = kv.shape[:2]
    rest = kv.shape[2:]
    ps = pool.shape[1]
    cap = table.shape[1] * ps
    lens = lens.long()
    t = torch.arange(C, device=table.device)
    pos_c = torch.clamp(lens[:, None] + t[None, :], max=cap - 1)   # [B, C]
    pages = torch.gather(table, 1, pos_c // ps).long()
    off = pos_c % ps
    # the lane that writes position cap - 1 (every dropped lane's source)
    last = torch.clamp(cap - 1 - lens, min=0)
    src = torch.minimum(t[None, :], last[:, None])
    bcast = (B, C) + (1,) * len(rest)
    vals = torch.gather(kv, 1, src.reshape(bcast).expand(kv.shape))
    dead = (lens >= cap).reshape((B,) + (1,) * (len(rest) + 1))
    vals = torch.where(dead, pool[pages, off], vals.to(pool.dtype))
    pool[pages.reshape(-1), off.reshape(-1)] = vals.reshape((B * C,) + rest)
    return pool


def _chunk_lens(lens, C, cap):
    """``[B, C]`` valid lengths of a chunk's positions: position t of slot
    b sees tokens ``0 .. lens[b] + t`` (its own K/V included), clamped at
    the table's reach ``cap``."""
    t = torch.arange(C, device=lens.device)
    return torch.clamp(lens.long()[:, None] + 1 + t[None, :], max=cap)


def _expand_rows(table, lens2):
    """The ``[B*C]``-row expansion the kernels take: each chunk position a
    row of its own, sharing its slot's page table (a contiguous int32
    copy) with its own length."""
    B, C = lens2.shape
    table2 = table[:, None, :].expand(B, C, table.shape[1]) \
        .reshape(B * C, -1).contiguous()
    return table2, lens2.reshape(-1).to(torch.int32).contiguous()


def paged_chunk_attend_ref(q, k_pages, v_pages, table, lens):
    """Plain version of :func:`paged_chunk_attend`, on any device: each
    slot's pages gathered once for all C positions."""
    B, C, H, D = q.shape
    NP, ps, HKV = table.shape[1], k_pages.shape[1], k_pages.shape[2]
    idx = table.long()
    k = k_pages[idx].reshape(B, NP * ps, HKV, D)
    v = v_pages[idx].reshape(B, NP * ps, HKV, D)
    return _gathered_chunk_attend(q, k, v, _chunk_lens(lens, C, NP * ps),
                                  1.0 / math.sqrt(D))


def paged_chunk_attend(q, k_pages, v_pages, table, lens):
    """Attend C query positions per slot against the pools: position t of
    slot b sees tokens ``0 .. lens[b] + t`` (the chunk is written before it
    attends, so causality inside the chunk comes from the per-position
    lengths).  q ``[B, C, H, D]`` -> ``[B, C, H, D]``.

    A CPU tensor takes the plain version: each slot's pages gathered once
    for all C positions.  A CUDA tensor launches K3 once over the
    ``[B*C]``-row expansion, as the TPU package does; each row re-reads its
    slot's pages."""
    if q.device.type == "cpu":
        return paged_chunk_attend_ref(q, k_pages, v_pages, table, lens)
    global CHUNK_LAUNCHES
    B, C, H, D = q.shape
    lens2 = _chunk_lens(lens, C, table.shape[1] * k_pages.shape[1])
    table2, rows = _expand_rows(table, lens2)
    out = paged_attention(q.reshape(B * C, H, D), k_pages, v_pages, table2,
                          rows)
    CHUNK_LAUNCHES += 1
    return out.reshape(B, C, H, D)


# ----------------------------------------------- generate()'s lock-step pools
# The pools of ``generate(cache_impl="paged")``: one pool per layer laid
# out per sequence, ``[B, PP, ps, h, d]`` (page i of sequence b is row
# ``b * PP + i`` of the flattened pool), and ONE position ``pos`` (a Python
# int, or a 0-d device tensor in a captured step) shared by the whole
# batch.  Written in place.


def paged_prefill_write(pages, kv):
    """Write whole prompts' K or V at position 0, in place: pages
    ``[B, PP, ps, h, d]``; kv ``[B, S, h, d]``, cast to the pages' dtype
    (a bf16 Llama's f32 rotated keys land in its bf16 pool).  The last
    page's tail past S is zeroed, as JAX's padded slice-assign does."""
    B, S, h, d = kv.shape
    ps = pages.shape[2]
    pad = (ps - S % ps) % ps
    if pad:
        kv = torch.cat([kv, kv.new_zeros((B, pad, h, d))], dim=1)
    chunks = kv.reshape(B, -1, ps, h, d)
    pages[:, :chunks.shape[1]] = chunks.to(pages.dtype)
    return pages


def paged_token_write(pages, tok, pos):
    """Write one token per sequence at position ``pos`` (a Python int, or
    a 0-d integer tensor on the pages' device: a captured decode step's),
    in place: pages ``[B, PP, ps, h, d]``; tok ``[B, h, d]``.  A page
    index past the pool clamps to its last page, as JAX's
    ``dynamic_update_slice`` does."""
    ps, PP = pages.shape[2], pages.shape[1]
    if isinstance(pos, torch.Tensor):
        p = pos.reshape(1).long()
        pages[:, torch.clamp(p // ps, max=PP - 1), p % ps] = \
            tok[:, None].to(pages.dtype)
        return pages
    pages[:, min(pos // ps, PP - 1), pos % ps] = tok.to(pages.dtype)
    return pages


def paged_decode_attend(q, k_pages, v_pages, pos, scale=None):
    """One decode step of attention over per-sequence pools: q ``[B, hq,
    d]``; pools ``[B, PP, ps, hkv, d]`` in q's dtype, or bf16 / f16 under
    an f32 q; tokens ``0 .. pos`` are valid (``pos`` a Python int or a 0-d
    integer tensor on q's device).

    A CPU tensor attends the reshaped pools directly (the identity table
    below makes the plain version's gathers pure copies).  A CUDA tensor
    launches K3 on the pools viewed as ``[B*PP, ps, hkv, d]`` (a view, so
    the token write and the attend see one storage) through the identity
    table ``b * PP + i``, as the TPU branch does."""
    B, PP, ps, hkv, d = k_pages.shape
    if isinstance(pos, torch.Tensor):
        lens = (pos.reshape(1) + 1).to(torch.int32).expand(B).contiguous()
    else:
        lens = torch.full((B,), pos + 1, dtype=torch.int32, device=q.device)
    if q.device.type == "cpu":
        sc = scale if scale is not None else 1.0 / math.sqrt(d)
        return _gathered_attend(q, k_pages.reshape(B, PP * ps, hkv, d),
                                v_pages.reshape(B, PP * ps, hkv, d), lens, sc)
    global DECODE_ATTEND_LAUNCHES
    dev = q.device
    table = (torch.arange(B, dtype=torch.int32, device=dev)[:, None] * PP
             + torch.arange(PP, dtype=torch.int32, device=dev)[None, :])
    out = paged_attention(q, k_pages.view(B * PP, ps, hkv, d),
                          v_pages.view(B * PP, ps, hkv, d), table, lens,
                          scale)
    DECODE_ATTEND_LAUNCHES += 1
    return out


# --------------------------------------------------- int8 quantized pools
# The quantized serving path (paddle_tpu_torch.serving.quant): K/V page
# pools stored as int8 with a PARALLEL SCALE POOL — one float32 scale per
# (page slot, kv head), i.e. each page carries a [ps, h] scale tile next to
# its [ps, h, d] int8 payload, addressed by the SAME page table.  Per-slot
# scales make every write self-contained (a token write never requantizes
# a page it shares with older tokens).  Quantization is fused into the
# pool writes and dequantization into the attention: K4 multiplies each
# int8 element by its scale while staging the page in shared memory, so no
# full-precision copy of the cache exists in device memory.  (The plain
# version dequantizes the GATHERED pages, a transient [B, T] working set.)


def quantize_kv(kv, bits=8):
    """Quantize K or V activations onto the pool grid: ``[..., h, d]`` ->
    ``(int8 [..., h, d], float32 scales [..., h])`` — absmax over d per
    position per head."""
    qv, scale = quantize_absmax(kv, axis=-1, bits=bits)
    return qv, scale.squeeze(-1)


def paged_table_prefill_write_quant(pool, spool, kv, table):
    """Quantizing twin of :func:`paged_table_prefill_write`: rounds the
    prompt's K or V into the int8 pool and writes the per-(slot, head)
    scales into the parallel scale pool, both in place.  pool
    ``[P, ps, h, d]`` int8; spool ``[P, ps, h]`` float32; kv
    ``[B, S, h, d]``; returns ``(pool, spool)``."""
    qv, sc = quantize_kv(kv)
    return (paged_table_prefill_write(pool, qv, table),
            paged_table_prefill_write(spool, sc, table))


def paged_table_token_write_quant(pool, spool, tok, table, lens):
    """Quantizing twin of :func:`paged_table_token_write` (one token per
    slot at its own position, in place).  tok ``[B, h, d]``; returns
    ``(pool, spool)``."""
    qv, sc = quantize_kv(tok)
    return (paged_table_token_write(pool, qv, table, lens),
            paged_table_token_write(spool, sc, table, lens))


def paged_table_chunk_write_quant(pool, spool, kv, table, lens):
    """Quantizing twin of :func:`paged_table_chunk_write` (C tokens per
    slot, the same drop semantics), in place.  kv ``[B, C, h, d]``;
    returns ``(pool, spool)``."""
    qv, sc = quantize_kv(kv)
    return (paged_table_chunk_write(pool, qv, table, lens),
            paged_table_chunk_write(spool, sc, table, lens))


def paged_attention_quantized_ref(q, k_pages, v_pages, k_scales, v_scales,
                                  page_table, seq_lens, scale=None):
    """Plain version of :func:`paged_attention_quantized` (K4) and of K5b,
    on any device: gather the int8 pages and their scale tiles, dequantize
    the gathered working set, then :func:`paged_attention_ref`'s math.
    Rows with ``seq_lens == 0`` give zeros, as every kernel does (the TPU
    package's oracle gives the mean of V)."""
    B, H, D = q.shape
    HKV, ps = k_pages.shape[2], k_pages.shape[1]
    NP = page_table.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    idx = page_table.long()
    k = k_pages[idx].float() * k_scales[idx].float()[..., None]
    v = v_pages[idx].float() * v_scales[idx].float()[..., None]
    return _gathered_attend(q, k.reshape(B, NP * ps, HKV, D),
                            v.reshape(B, NP * ps, HKV, D), seq_lens, scale)


def paged_attention_quantized(q, k_pages, v_pages, k_scales, v_scales,
                              page_table, seq_lens, scale=None):
    """Decode attention over int8 paged pools with the dequantization
    fused into the kernel (K4).

    q ``[B, H, D]`` (f32 / f16 / bf16); k_pages / v_pages
    ``[P, ps, HKV, D]`` int8; k_scales / v_scales ``[P, ps, HKV]``
    float32; page_table ``[B, NP]`` int32; seq_lens ``[B]`` int32; output
    in q's dtype.  Same table / masking / GQA contract as
    :func:`paged_attention`.  A CPU tensor takes the plain version; a CUDA
    tensor launches K4 or raises."""
    scale = _check_heads(q, k_pages, scale)
    if q.device.type == "cpu":
        return paged_attention_quantized_ref(q, k_pages, v_pages, k_scales,
                                             v_scales, page_table, seq_lens,
                                             scale)
    global QUANT_LAUNCHES
    o = _launch(q, k_pages, v_pages, k_scales, v_scales, page_table,
                seq_lens, scale, bounded=True)
    QUANT_LAUNCHES += 1
    return o


def _paged_q_full_sweep(q, k_pages, v_pages, k_scales, v_scales, page_table,
                        seq_lens, scale=None):
    """K5b: :func:`paged_attention_quantized`'s function with the legacy
    full sweep (the TPU package's ``_paged_q_pallas``).  Only tests call
    it; its plain version is :func:`paged_attention_quantized_ref`."""
    scale = _check_heads(q, k_pages, scale)
    if q.device.type == "cpu":
        return paged_attention_quantized_ref(q, k_pages, v_pages, k_scales,
                                             v_scales, page_table, seq_lens,
                                             scale)
    global QUANT_FULL_SWEEP_LAUNCHES
    o = _launch(q, k_pages, v_pages, k_scales, v_scales, page_table,
                seq_lens, scale, bounded=False)
    QUANT_FULL_SWEEP_LAUNCHES += 1
    return o


def paged_chunk_attend_quant_ref(q, k_pages, v_pages, k_scales, v_scales,
                                 table, lens):
    """Plain version of :func:`paged_chunk_attend_quant`, on any device:
    one gather and dequantization per slot for all C positions."""
    B, C, H, D = q.shape
    NP, ps, HKV = table.shape[1], k_pages.shape[1], k_pages.shape[2]
    idx = table.long()
    k = k_pages[idx].float() * k_scales[idx].float()[..., None]
    v = v_pages[idx].float() * v_scales[idx].float()[..., None]
    return _gathered_chunk_attend(q, k.reshape(B, NP * ps, HKV, D),
                                  v.reshape(B, NP * ps, HKV, D),
                                  _chunk_lens(lens, C, NP * ps),
                                  1.0 / math.sqrt(D))


def paged_chunk_attend_quant(q, k_pages, v_pages, k_scales, v_scales, table,
                             lens):
    """Quantized twin of :func:`paged_chunk_attend` over int8 pools with
    their float32 scale pools: on the CPU one gather and dequantization
    per slot for all C positions, on the card one K4 launch over the
    ``[B*C]``-row expansion.  q ``[B, C, H, D]`` -> ``[B, C, H, D]``."""
    if q.device.type == "cpu":
        return paged_chunk_attend_quant_ref(q, k_pages, v_pages, k_scales,
                                            v_scales, table, lens)
    global QUANT_CHUNK_LAUNCHES
    B, C, H, D = q.shape
    lens2 = _chunk_lens(lens, C, table.shape[1] * k_pages.shape[1])
    table2, rows = _expand_rows(table, lens2)
    out = paged_attention_quantized(q.reshape(B * C, H, D), k_pages, v_pages,
                                    k_scales, v_scales, table2, rows)
    QUANT_CHUNK_LAUNCHES += 1
    return out.reshape(B, C, H, D)


class PagedKVCache:
    """Block-paged KV cache (the allocator side of PagedAttention): pages
    from one pool ``[num_seqs * max_pages_per_seq, ps, h, d]``, page i of
    sequence b at row ``b * max_pages_per_seq + i`` (static round-robin
    table), per-sequence lengths.  Updated in place.  ``device`` None
    means the card."""

    def __init__(self, num_seqs, max_pages_per_seq, page_size, num_heads,
                 head_dim, dtype=torch.bfloat16, device=None):
        from ..device import resolve_device

        dev = resolve_device(device)
        self.page_size = page_size
        self.capacity = max_pages_per_seq * page_size
        total = num_seqs * max_pages_per_seq
        self.k_pages = torch.zeros((total, page_size, num_heads, head_dim),
                                   dtype=dtype, device=dev)
        self.v_pages = torch.zeros_like(self.k_pages)
        self.page_table = (torch.arange(num_seqs)[:, None] * max_pages_per_seq
                           + torch.arange(max_pages_per_seq)[None, :]) \
            .to(device=dev, dtype=torch.int32)
        self.seq_lens = torch.zeros((num_seqs,), dtype=torch.int32, device=dev)

    def append(self, k_tok, v_tok):
        """Write one token's K / V per sequence (``[B, H, D]``) at each
        sequence's length; returns self.  Raises when a sequence is already
        at capacity (an index past the table would otherwise overwrite the
        last page): size ``max_pages_per_seq`` for the longest decode."""
        if int(self.seq_lens.max()) >= self.capacity:
            raise RuntimeError(
                f"PagedKVCache overflow: a sequence is at capacity "
                f"{self.capacity} tokens ({self.capacity // self.page_size}"
                " pages); grow max_pages_per_seq")
        lens = self.seq_lens.long()
        rows = torch.arange(k_tok.shape[0], device=lens.device)
        pages = self.page_table[rows, lens // self.page_size].long()
        off = lens % self.page_size
        self.k_pages[pages, off] = k_tok.to(self.k_pages.dtype)
        self.v_pages[pages, off] = v_tok.to(self.v_pages.dtype)
        self.seq_lens += 1
        return self

    def attend(self, q):
        return paged_attention(q, self.k_pages, self.v_pages,
                               self.page_table, self.seq_lens)
