"""Build and load the port's CUDA kernels.

Each ``paddle_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
Hopper (``sm_90a``) into a shared library with a plain C interface and
loaded with :mod:`ctypes` — no PyTorch headers, so a build takes seconds.
Libraries land in a content-hashed file under the build directory
(``<checkout>/build/kernels`` unless ``PADDLE_TPU_TORCH_BUILD_DIR`` names
another), so a changed source or flag set builds anew and an unchanged one
loads at once.  A file lock per library keeps two processes from building
the same one at the same time.  Nothing is built at import: the first
wrapper call on a CUDA tensor (or :func:`build`) does it.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes of csrc/common.cuh (enum DType)
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()

#: nvcc's output (ptxas registers / shared memory / spills) of the last
#: build of each library in this process, or of the cached build it loaded
BUILD_LOGS: dict[str, str] = {}

#: wall seconds this process spent in builds that ran ``nvcc`` (a kernel's
#: first use with no cached library): the serving engine bills the growth
#: over a dispatch to the requests that waited it out (cold TTFT)
BUILD_SECONDS = 0.0


def dtype_code(t: torch.Tensor) -> int:
    try:
        return _DTYPE_CODES[t.dtype]
    except KeyError:
        raise TypeError(f"the CUDA kernels take float32, float16 or bfloat16, "
                        f"got {t.dtype}") from None


def build_dir() -> Path:
    env = os.environ.get("PADDLE_TPU_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return CSRC.parent.parent / "build" / "kernels"


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "are compiled on first use on the machine with "
                           "the card")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def build(*names: str) -> dict[str, Path]:
    """Compile every named source that has no up-to-date library yet, all
    ``nvcc`` processes at once, and return ``{name: library path}``.
    Raises ``RuntimeError`` with the compiler's output if a build fails."""
    global BUILD_SECONDS
    t0 = time.perf_counter()
    targets = {n: _target(n) for n in names}
    build_dir().mkdir(parents=True, exist_ok=True)
    locks = []
    procs = {}
    try:
        for n in sorted(targets):
            f = open(targets[n].with_suffix(".lock"), "w")
            locks.append(f)
            fcntl.flock(f, fcntl.LOCK_EX)
        for n, out in targets.items():
            if out.exists():
                log = out.with_suffix(".log")
                BUILD_LOGS[n] = log.read_text() if log.exists() else ""
                continue
            tmp = out.with_name(out.name + f".tmp{os.getpid()}")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        tmp)
        failed = []
        for n, (p, tmp) in procs.items():
            log, _ = p.communicate()
            BUILD_LOGS[n] = log
            if p.returncode != 0:
                failed.append(f"{n}.cu (nvcc exit {p.returncode}):\n{log}")
                continue
            targets[n].with_suffix(".log").write_text(log)
            os.replace(tmp, targets[n])
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    finally:
        for f in locks:
            f.close()           # closing the file releases its lock
        if procs:
            BUILD_SECONDS += time.perf_counter() - t0
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build(name)[name]))
        return lib


def loaded(name: str) -> bool:
    """Whether ``csrc/<name>.cu``'s library is loaded in this process (a
    first call that is not may spend seconds in ``nvcc``)."""
    return name in _libs


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a non-zero cudaError_t."""
    if err:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{err}")


def stream_handle(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def needs_grad(*tensors) -> bool:
    """Whether autograd would differentiate a call on these tensors."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def check_no_grad(*tensors) -> None:
    """Paged decode (K3) has no backward: it is inference-only, as in the
    TPU package.  Refuse a call that autograd would need to differentiate,
    rather than return an output that silently has no gradient."""
    if needs_grad(*tensors):
        raise NotImplementedError(
            "paged flash decode is inference-only (it has no backward): "
            "call it under torch.no_grad() / torch.inference_mode()")


# --------------------------------------------------------- launch counters
# each wrapper adds one to its module's counter where it launches its
# kernel; engines on several threads launch (and capture) at once, so the
# counters move under a lock, and a thread capturing a CUDA graph records
# its launches as the graph's own (its replays add them) instead
_COUNT_LOCK = threading.Lock()
_COUNT_TLS = threading.local()


def count_launch(g, name, body=None):
    """One launch on the counter ``name`` of the module whose globals are
    ``g`` (``body``: the key of a per-body dict counter)."""
    rec = getattr(_COUNT_TLS, "record", None)
    if rec is not None:
        key = (sys.modules[g["__name__"]], name)
        if body is None:
            rec[key] = rec.get(key, 0) + 1
        else:
            d = rec.setdefault(key, {})
            d[body] = d.get(body, 0) + 1
        return
    with _COUNT_LOCK:
        if body is None:
            g[name] += 1
        else:
            g[name][body] = g[name].get(body, 0) + 1


def add_launches(delta):
    """Add a recorded ``{(module, name): count or {body: count}}`` delta
    to the counters (a graph replay's launches)."""
    with _COUNT_LOCK:
        for (m, name), d in delta.items():
            cur = getattr(m, name)
            if isinstance(cur, dict):
                for j, n in d.items():
                    cur[j] = cur.get(j, 0) + n
            else:
                setattr(m, name, cur + d)


@contextlib.contextmanager
def recording_launches():
    """This thread's launches go to the yielded dict, not the counters
    (a capture: its kernels run at replay)."""
    prev = getattr(_COUNT_TLS, "record", None)
    rec = _COUNT_TLS.record = {}
    try:
        yield rec
    finally:
        _COUNT_TLS.record = prev
