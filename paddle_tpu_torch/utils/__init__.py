"""paddle_tpu_torch.utils (counterpart of ``paddle_tpu/utils``): the
custom-op plugin surface, ``SummaryWriter`` and the reference's small
helpers (``try_import``, ``run_check``, ``require_version``,
``deprecated``)."""

from ..framework.custom_op import load_op_library, register_op  # noqa: F401
from .summary_writer import SummaryWriter  # noqa: F401


def try_import(module_name, err_msg=None):
    """The module, or an ``ImportError`` carrying ``err_msg``."""
    import importlib

    try:
        return importlib.import_module(module_name)
    except ImportError:
        raise ImportError(err_msg or f"{module_name} is not installed")


def run_check():
    """paddle.utils.run_check: one product on the default device (the card
    when there is one, else the CPU) checked against its known value."""
    import torch

    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    x = torch.ones(8, 8, device=dev)
    ok = float((x @ x)[0, 0]) == 8.0
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    print(f"PaddleTPU works on {dev.type}:{x.device.index or 0} "
          f"({'OK' if ok else 'FAILED'}), {n} device(s) visible")
    return ok


def require_version(min_version, max_version=None):
    """Accepted, as the reference accepts it: always True."""
    return True


def deprecated(update_to="", since="", reason="", level=0):
    """A decorator that leaves the function as it is, as the reference's."""
    def wrapper(fn):
        return fn

    return wrapper
