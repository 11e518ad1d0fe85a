"""Flash attention on Hopper, forward and backward (counterpart of
``paddle_tpu/ops/flash_attention.py``).

The TPU package runs three Pallas kernels: ``_fa_kernel`` (forward, K1)
and the two backward kernels ``_fa_bwd_dkdv_kernel`` (K2a) and
``_fa_bwd_dq_kernel`` (K2b) behind a ``jax.custom_vjp``.  Here they are
the hand-written CUDA kernels ``csrc/flash_attention_fwd.cu`` and
``csrc/flash_attention_bwd.cu`` (their headers say what bounds them on the
card and how they are laid out), behind the ``torch.autograd.Function``
:class:`_FlashAttention`.  :func:`flash_attention_fn` is the public entry
in the paddle ``[B, S, H, D]`` layout:

- a CPU tensor takes the plain PyTorch versions (:func:`flash_attention_ref`
  forward, :func:`flash_attention_bwd_ref` backward);
- a CUDA tensor launches the kernels, or raises for what they do not take
  (GQA, head_dim > 256, a causal call with more queries than keys), in the
  forward, before any compute.  There is no quiet fallback.

The backward takes, as the TPU package's ``_bwd_dispatch`` does,
``delta = sum(g * o)`` (one torch reduction, outside the kernels) and the
row correction ``r = delta - g_lse``, so :func:`flash_attention_with_lse`
is differentiable in both of its outputs at no extra cost.

``LAUNCHES``, ``BWD_DKDV_LAUNCHES`` and ``BWD_DQ_LAUNCHES`` count kernel
launches, so a run can show that its attention went through the kernels;
``FWD_BODY_LAUNCHES`` / ``BWD_BODY_LAUNCHES`` split them by the body the C
entry chose: ``"tc16"``, bf16 / f16 by 16-bit tensor-core products, and
``"3xtf32"``, f32 by 3xTF32 tensor-core products.  Forward and backward
run on the tensor cores at every head_dim (1-256).
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

NEG_INF = -1e30
#: widest head_dim the kernels take, forward and backward (the TPU
#: package's limit)
MAX_HEAD_DIM = 256

#: number of times each CUDA kernel was launched in this process
LAUNCHES = 0                # K1, forward
BWD_DKDV_LAUNCHES = 0       # K2a, dk / dv
BWD_DQ_LAUNCHES = 0         # K2b, dq
#: the same launches by body (K2a and K2b together), as the C entries'
#: ``*_body`` functions name it
FWD_BODY_LAUNCHES = {"tc16": 0, "3xtf32": 0}
BWD_BODY_LAUNCHES = {"tc16": 0, "3xtf32": 0}
# csrc enums FwdBody and BwdBody, which share their numbers
_BODIES = {1: "tc16", 2: "3xtf32"}


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


def _from_bh(x, b, h):
    bh, s, d = x.shape
    return x.reshape(b, h, s, d).permute(0, 2, 1, 3)


def flash_attention_ref(q, k, v, scale=None, causal=False):
    """Plain version of :func:`flash_attention_fn` on ``[B, S, H, D]``, on
    any device: the yardstick the kernel is held to."""
    b, sq, h, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    return _from_bh(_ref_attention(_to_bh(q), _to_bh(k), _to_bh(v), scale,
                                   causal), b, h)


def flash_attention_lse_ref(q, k, scale=None, causal=False):
    """Plain per-row logsumexp ``[B * H, Sq]`` (f32) of the scaled scores,
    on any device."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return torch.logsumexp(_scores(_to_bh(q), _to_bh(k), scale, causal), dim=-1)


def flash_attention_bwd_ref(q, k, v, g, lse, r, scale, causal):
    """Plain version of the backward kernels K2a + K2b, on any device.

    ``q, g``: ``[B, Sq, H, D]``; ``k, v``: ``[B, Sk, H, D]``; ``lse`` and the
    row correction ``r = delta - g_lse``: ``[B * H, Sq]`` f32.  Does the
    kernels' math from the saved lse, in f32: ``p = exp(s * scale - lse)``,
    masked; ``ds = p * (g.v^T - r) * scale``; returns ``(dq, dk, dv)`` in
    the inputs' layout and dtypes."""
    b, _, h, _ = q.shape
    qf, kf, vf, gf = (_to_bh(x).float() for x in (q, k, v, g))
    p = torch.exp(_scores(qf, kf, scale, causal) - lse[..., None])
    dv = torch.einsum("bqk,bqd->bkd", p, gf)
    dp = torch.einsum("bqd,bkd->bqk", gf, vf)
    ds = p * (dp - r[..., None]) * scale
    dq = torch.einsum("bqk,bkd->bqd", ds, kf)
    dk = torch.einsum("bqk,bqd->bkd", ds, qf)
    return (_from_bh(dq, b, h).to(q.dtype), _from_bh(dk, b, h).to(k.dtype),
            _from_bh(dv, b, h).to(v.dtype))


def supported(q_shape, k_shape, causal=False) -> bool:
    """Whether the CUDA kernels, forward and backward, take these
    ``[B, S, H, D]`` shapes: 4-D, as many kv heads as query heads,
    head_dim <= ``MAX_HEAD_DIM``, and for a causal call no more queries
    than keys.  Unlike the TPU kernels there is no sequence floor: the
    ragged tile is masked in the kernels, so they take every length."""
    if len(q_shape) != 4 or len(k_shape) != 4:
        return False
    b, sq, h, d = q_shape
    if k_shape[0] != b or k_shape[2] != h or k_shape[3] != d:
        return False
    if d > MAX_HEAD_DIM:
        return False
    return not (causal and sq > k_shape[1])


def flash_attention_bshd(q, k, v, causal=False, scale=None):
    """``[B, S, H, D]`` front-end used by
    ``nn.functional.scaled_dot_product_attention``."""
    return flash_attention_fn(q, k, v, scale=scale, causal=causal)


def flash_attention_fn(q, k, v, scale=None, causal=False, return_lse=False):
    """Attention in the paddle ``[B, S, H, D]`` layout.

    ``return_lse=True`` also returns the per-row logsumexp ``[B * H, Sq]``
    in f32.  The output has q's dtype; the softmax runs in f32 either way.
    A call that needs a gradient goes through :class:`_FlashAttention`
    (differentiable in both outputs)."""
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    grad = _build.needs_grad(q, k, v)
    if q.device.type != "cpu":
        _check_cuda_args(q, k, v, causal, grad)
    if grad:
        o, lse = _FlashAttention.apply(q, k, v, scale, causal)
        return (o, lse) if return_lse else o
    if q.device.type == "cpu":
        o = flash_attention_ref(q, k, v, scale, causal)
        if not return_lse:
            return o
        return o, flash_attention_lse_ref(q, k, scale, causal)
    o, lse = _fwd_kernel(q, k, v, scale, causal, return_lse)
    return (o, lse) if return_lse else o


def flash_attention_with_lse(q, k, v, scale, causal, block_q=None,
                             block_k=None):
    """``[BH, S, D]`` block attention returning ``(o, lse [BH, S, 1] f32)``,
    differentiable in both outputs (the ring-attention primitive).
    ``block_q`` / ``block_k`` are accepted for the TPU signature; the CUDA
    kernels use their own 64-row tiles and take any length."""
    o, lse = flash_attention_fn(q[:, :, None], k[:, :, None], v[:, :, None],
                                scale=scale, causal=causal, return_lse=True)
    return o[:, :, 0], lse[..., None]


class _FlashAttention(torch.autograd.Function):
    """``(o, lse) = attention(q, k, v)`` with K1 forward and K2a + K2b
    backward on the card (the TPU package's ``_flash_lse`` custom vjp);
    the plain versions on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        if q.device.type == "cpu":
            o = flash_attention_ref(q, k, v, scale, causal)
            lse = flash_attention_lse_ref(q, k, scale, causal)
        else:
            o, lse = _fwd_kernel(q, k, v, scale, causal, True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.causal = scale, causal
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g, g_lse):
        q, k, v, o, lse = ctx.saved_tensors
        b, sq, h, _ = q.shape
        g = torch.zeros_like(o) if g is None else g.to(q.dtype).contiguous()
        delta = (g.float() * o.float()).sum(-1).transpose(1, 2).reshape(b * h, sq)
        r = delta if g_lse is None else delta - g_lse.float()
        if q.device.type == "cpu":
            dq, dk, dv = flash_attention_bwd_ref(q, k, v, g, lse, r,
                                                 ctx.scale, ctx.causal)
        else:
            dq, dk, dv = _bwd_kernels(q, k, v, g, lse, r.contiguous(),
                                      ctx.scale, ctx.causal)
        return dq, dk, dv, None, None


def _check_cuda_args(q, k, v, causal, grad):
    """Raise, before any compute, for a call the kernels do not take."""
    if not supported(q.shape, k.shape, causal):
        raise NotImplementedError(
            f"the flash attention kernels do not take q {tuple(q.shape)} / "
            f"k {tuple(k.shape)} (causal={causal}, needs_grad={grad}): they "
            f"need equal head counts (a GQA model repeats its K / V heads "
            f"first, as Llama does), "
            f"head_dim <= {MAX_HEAD_DIM} and, when causal, no more queries "
            f"than keys")
    if q.device.type != "cuda":
        raise NotImplementedError(
            f"flash attention runs on cuda or cpu tensors, got {q.device}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if k.shape != v.shape:
        raise ValueError(f"k and v shapes differ: {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1:
            raise ValueError(f"{name} must be unit-stride in head_dim")


def _strides(*xs):
    return (ctypes.c_longlong * (3 * len(xs)))(
        *(x.stride(i) for x in xs for i in range(3)))


def _fwd_kernel(q, k, v, scale, causal, return_lse):
    """Launch K1: ``o`` ``[B, Sq, H, D]`` and, when asked, ``lse``."""
    b, sq, h, d = q.shape
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, sq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    lib = _lib("flash_attention_fwd")
    with torch.cuda.device(q.device):
        err = lib.ptt_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            _build.dtype_code(q), b, h, sq, k.shape[1], d, _strides(q, k, v),
            scale, int(bool(causal)), _build.stream_handle(q))
    _build.check(err, "flash_attention_fwd")
    _report_cost(q, k, causal, return_lse)
    _build.count_launch(globals(), "LAUNCHES")
    _build.count_launch(globals(), "FWD_BODY_LAUNCHES", _BODIES[
        lib.ptt_flash_attention_fwd_body(_build.dtype_code(q), d)])
    return o, lse


def _report_cost(q, k, causal, return_lse):
    """K1's analytic cost for the perf table's counted step (a ctypes
    launch is invisible to the flop counter): 4 * D operations per visible
    (query, key) pair per head; q, k, v read and o (and lse) written
    once."""
    from ..observability import perf as _perf

    if not _perf.counting_kernels():
        return
    b, sq, h, d = q.shape
    sk = k.shape[1]
    pairs = sq * (sk - sq) + sq * (sq + 1) // 2 if causal else sq * sk
    elt = q.element_size()
    nbytes = elt * b * h * d * (2 * sq + 2 * sk) \
        + (4 * b * h * sq if return_lse else 0)
    _perf.kernel_cost(4 * d * pairs * b * h, nbytes)


def _bwd_kernels(q, k, v, g, lse, r, scale, causal):
    """Launch K2a then K2b: ``(dq, dk, dv)``, contiguous, in q's dtype."""
    dk, dv = _bwd_dkdv_kernel(q, k, v, g, lse, r, scale, causal)
    return _bwd_dq_kernel(q, k, v, g, lse, r, scale, causal), dk, dv


def _bwd_args(q, k, v, g, scale, causal):
    b, sq, h, d = q.shape
    return (_build.dtype_code(q), b, h, sq, k.shape[1], d, _strides(q, k, v, g),
            scale, int(bool(causal)), _build.stream_handle(q))


def _bwd_dkdv_kernel(q, k, v, g, lse, r, scale, causal):
    """Launch K2a: ``(dk, dv)`` ``[B, Sk, H, D]``."""
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    lib = _lib("flash_attention_bwd")
    with torch.cuda.device(q.device):
        err = lib.ptt_flash_attention_bwd_dkdv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), r.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *_bwd_args(q, k, v, g, scale, causal))
    _build.check(err, "flash_attention_bwd_dkdv")
    _build.count_launch(globals(), "BWD_DKDV_LAUNCHES")
    _count_bwd_body(lib, q)
    return dk, dv


def _bwd_dq_kernel(q, k, v, g, lse, r, scale, causal):
    """Launch K2b: ``dq`` ``[B, Sq, H, D]``."""
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lib = _lib("flash_attention_bwd")
    with torch.cuda.device(q.device):
        err = lib.ptt_flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), r.data_ptr(), dq.data_ptr(),
            *_bwd_args(q, k, v, g, scale, causal))
    _build.check(err, "flash_attention_bwd_dq")
    _build.count_launch(globals(), "BWD_DQ_LAUNCHES")
    _count_bwd_body(lib, q)
    return dq


def _count_bwd_body(lib, q):
    _build.count_launch(globals(), "BWD_BODY_LAUNCHES", _BODIES[
        lib.ptt_flash_attention_bwd_body(_build.dtype_code(q), q.shape[-1])])


_ARGTYPES = {
    # q, k, v, o, lse | dtype, B, H, Sq, Sk, D | strides, scale, causal, stream
    "ptt_flash_attention_fwd": 5,
    # q, k, v, g, lse, r, dk, dv | ...
    "ptt_flash_attention_bwd_dkdv": 8,
    # q, k, v, g, lse, r, dq | ...
    "ptt_flash_attention_bwd_dq": 7,
}


def _lib(name):
    lib = _build.load(name)
    P, I = ctypes.c_void_p, ctypes.c_int
    for fn_name, n_ptrs in _ARGTYPES.items():
        fn = getattr(lib, fn_name, None)
        if fn is not None and fn.argtypes is None:
            fn.argtypes = [P] * n_ptrs + [I] * 6 + [
                ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, I, P]
            fn.restype = I
    for fn_name in ("ptt_flash_attention_fwd_body",
                    "ptt_flash_attention_bwd_body"):    # (dtype, D) -> body
        fn = getattr(lib, fn_name, None)
        if fn is not None and fn.argtypes is None:
            fn.argtypes = [I, I]
            fn.restype = I
    return lib
