"""``save`` / ``load`` (counterpart of ``paddle_tpu/framework/io.py``), in
the reference's pickle schema, so a ``.pdparams`` written by either
package loads in the other.

Each tensor is stored as ``{"__tensor__": True, "dtype": <numpy-style
name>, "data": <numpy array>, "param": <is a parameter>}``; bfloat16 data
is kept as its ``uint16`` bit pattern (numpy has no bfloat16) and read
back through ``view(torch.bfloat16)``.  Dicts, lists and tuples are walked;
anything else is pickled as it is.  Layout is the caller's business:
``hapi.Model.save`` hands over paddle's ``[in, out]`` Linear weights
(``text.models.export_paddle_tpu_state_dict``).
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch


def _dtype_name(t):
    return str(t.dtype).replace("torch.", "")


def _to_serializable(obj):
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        if t.dtype == torch.bfloat16:
            data = t.contiguous().view(torch.int16).numpy().view(np.uint16)
        else:
            data = t.numpy()
        return {"__tensor__": True, "dtype": _dtype_name(t),
                "data": data.copy(),
                "param": isinstance(obj, torch.nn.Parameter)}
    if isinstance(obj, dict):
        return {k: _to_serializable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_serializable(v) for v in obj)
    return obj


def _from_serializable(obj, return_numpy=False):
    if isinstance(obj, dict):
        if obj.get("__tensor__"):
            data = np.asarray(obj["data"])
            if obj["dtype"] == "bfloat16":
                t = torch.from_numpy(data.view(np.int16).copy()).view(
                    torch.bfloat16)
                return t.float().numpy() if return_numpy else t
            if return_numpy:
                return data
            t = torch.from_numpy(np.array(data))
            return torch.nn.Parameter(t, requires_grad=False) \
                if obj.get("param") else t
        return {k: _from_serializable(v, return_numpy)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_serializable(v, return_numpy) for v in obj)
    return obj


def save(obj, path, protocol=4, **configs):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_to_serializable(obj), f, protocol=protocol)


def load(path, return_numpy=False, **configs):
    """The saved object, tensors as CPU torch tensors (parameters as
    ``torch.nn.Parameter``), or numpy arrays with ``return_numpy``
    (bfloat16 widened to float32)."""
    with open(path, "rb") as f:
        obj = pickle.load(f)
    return _from_serializable(obj, return_numpy)
