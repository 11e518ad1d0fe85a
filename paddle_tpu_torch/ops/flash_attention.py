"""Flash attention forward on Hopper (counterpart of
``paddle_tpu/ops/flash_attention.py``).

The TPU package runs a Pallas kernel (``_flash_fwd`` -> ``_fa_kernel``);
here the same function is the hand-written CUDA kernel
``csrc/flash_attention_fwd.cu`` (its header says what bounds it on the card
and how it is laid out).  :func:`flash_attention_fn` is the public entry in
the paddle ``[B, S, H, D]`` layout:

- a CPU tensor takes the plain PyTorch version :func:`_ref_attention`;
- a CUDA tensor launches the kernel, or raises for what the kernel does
  not take (GQA, D > 256, a causal call with more queries than keys).
  There is no quiet fallback.

``LAUNCHES`` counts kernel launches, so a run can show that its prefills
went through the kernel.  The backward kernels (K2) come with the
training slice.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

NEG_INF = -1e30

#: number of times the CUDA kernel was launched in this process
LAUNCHES = 0


def _scores(q, k, scale, causal):
    """Scaled f32 scores ``[BH, Sq, Sk]``; the causal mask is aligned
    bottom-right (``tril(k=sk - sq)``)."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        mask = torch.ones(sq, sk, dtype=torch.bool, device=s.device).tril(sk - sq)
        s = s.masked_fill(~mask, NEG_INF)
    return s


def _ref_attention(q, k, v, scale, causal):
    """Plain attention over ``[BH, S, D]`` in f32, cast back to q's dtype
    (the TPU package's ``_ref_attention``)."""
    p = torch.softmax(_scores(q, k, scale, causal), dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def _to_bh(x):
    b, s, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, s, d)


def flash_attention_ref(q, k, v, scale=None, causal=False):
    """Plain version of :func:`flash_attention_fn` on ``[B, S, H, D]``, on
    any device: the yardstick the kernel is held to."""
    b, sq, h, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    o = _ref_attention(_to_bh(q), _to_bh(k), _to_bh(v), scale, causal)
    return o.reshape(b, h, sq, d).permute(0, 2, 1, 3)


def flash_attention_lse_ref(q, k, scale=None, causal=False):
    """Plain per-row logsumexp ``[B * H, Sq]`` (f32) of the scaled scores,
    on any device."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return torch.logsumexp(_scores(_to_bh(q), _to_bh(k), scale, causal), dim=-1)


def supported(q_shape, k_shape, causal=False) -> bool:
    """Whether the CUDA kernel takes these ``[B, S, H, D]`` shapes: 4-D,
    as many kv heads as query heads, head_dim <= 256, and for a causal call
    no more queries than keys.  Unlike the TPU kernel there is no sequence
    floor: the ragged tile is masked in the kernel, so it serves every
    prompt length."""
    if len(q_shape) != 4 or len(k_shape) != 4:
        return False
    b, sq, h, d = q_shape
    if k_shape[0] != b or k_shape[2] != h or k_shape[3] != d:
        return False
    if d > 256:
        return False
    return not (causal and sq > k_shape[1])


def flash_attention_bshd(q, k, v, causal=False, scale=None):
    """``[B, S, H, D]`` front-end used by
    ``nn.functional.scaled_dot_product_attention``."""
    return flash_attention_fn(q, k, v, scale=scale, causal=causal)


def flash_attention_fn(q, k, v, scale=None, causal=False, return_lse=False):
    """Attention in the paddle ``[B, S, H, D]`` layout.

    ``return_lse=True`` also returns the per-row logsumexp ``[B * H, Sq]``
    in f32 (what ring attention merges blocks with).  The output has q's
    dtype; the softmax runs in f32 either way."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        o = flash_attention_ref(q, k, v, scale, causal)
        if not return_lse:
            return o
        return o, flash_attention_lse_ref(q, k, scale, causal)
    _check_cuda_args(q, k, v, causal)
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, sq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    strides = (ctypes.c_longlong * 9)(*(x.stride(i) for x in (q, k, v)
                                        for i in range(3)))
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.ptt_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            _build.dtype_code(q), b, h, sq, sk, d, strides, scale,
            int(bool(causal)), _build.stream_handle(q))
    _build.check(err, "flash_attention_fwd")
    global LAUNCHES
    LAUNCHES += 1
    return (o, lse) if return_lse else o


def _check_cuda_args(q, k, v, causal):
    if q.device.type != "cuda":
        raise NotImplementedError(
            f"flash attention runs on cuda or cpu tensors, got {q.device}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    _build.check_no_grad(q, k, v)
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"expected [B, S, H, D] q and equal k/v shapes, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not supported(q.shape, k.shape, causal):
        raise NotImplementedError(
            f"the flash attention kernel does not take q {tuple(q.shape)} / "
            f"k {tuple(k.shape)} (causal={causal}): it needs equal head "
            f"counts (GQA comes with the Llama slice), head_dim <= 256 and, "
            f"when causal, no more queries than keys")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1:
            raise ValueError(f"{name} must be unit-stride in head_dim")


def _lib():
    lib = _build.load("flash_attention_fwd")
    fn = lib.ptt_flash_attention_fwd
    if fn.argtypes is None:
        P = ctypes.c_void_p
        I = ctypes.c_int
        fn.argtypes = [P, P, P, P, P, I, I, I, I, I, I,
                       ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, I, P]
        fn.restype = I
    return lib
