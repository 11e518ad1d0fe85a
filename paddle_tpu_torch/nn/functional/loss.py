"""Loss functionals (counterpart of ``paddle_tpu/nn/functional/loss.py``).

``cross_entropy`` only, for the training slice: softmax cross-entropy with
hard int labels (``ignore_index``, class ``weight``, ``label_smoothing``)
or soft labels, ``reduction`` mean / sum / none.  ``log_softmax`` runs in
f32 (``cross_entropy`` is on the AMP black list), so the loss is f32.
"""

from __future__ import annotations

import torch


def cross_entropy(input, label, weight=None, ignore_index=-100, reduction="mean",
                  soft_label=False, axis=-1, use_softmax=True, label_smoothing=0.0,
                  name=None):
    """Softmax cross-entropy over ``axis``.  With int labels, a mean
    divides by the (weighted) count of labels that are not
    ``ignore_index``."""
    logits = input.float()
    w = weight.float() if weight is not None else None
    axis = axis % logits.ndim
    if use_softmax:
        logp = torch.log_softmax(logits, dim=axis)
    else:
        logp = torch.log(torch.clamp(logits, 1e-15, 1.0))
    k = logits.shape[axis]
    if soft_label:
        soft = label.float()
        if label_smoothing > 0:
            soft = (1 - label_smoothing) * soft + label_smoothing / k
        out = -torch.sum(soft * logp, dim=axis)
        if w is not None:
            out = out * torch.sum(soft * w, dim=axis)
        if reduction == "mean":
            return out.mean()
        return out.sum() if reduction == "sum" else out
    ids = label.long()
    if ids.ndim == logp.ndim:                   # (N, ..., 1) int form
        ids = ids.squeeze(axis)
    valid = ids != ignore_index
    safe = torch.where(valid, ids, torch.zeros_like(ids))
    nll = -torch.gather(logp, axis, safe.unsqueeze(axis)).squeeze(axis)
    if label_smoothing > 0:
        nll = nll * (1 - label_smoothing) \
            - label_smoothing / k * torch.sum(logp, dim=axis)
    if w is not None:
        cw = w[safe]
        nll = nll * cw
        wsum = torch.sum(torch.where(valid, cw, torch.zeros_like(cw)))
    else:
        wsum = torch.sum(valid.to(nll.dtype))
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    if reduction == "mean":
        return torch.sum(nll) / torch.clamp(wsum, min=1e-12)
    if reduction == "sum":
        return torch.sum(nll)
    return nll
