"""Scalar summary writer (counterpart of
``paddle_tpu/utils/summary_writer.py``, copied: pure Python), behind the
``VisualDL`` callback.

Writes JSONL scalar events (``scalars.jsonl``, the greppable record) and
TensorBoard event files via the dependency-free encoder in
:mod:`._tfevents`: point TensorBoard at ``logdir``.
"""

from __future__ import annotations

import json
import os
import time


class SummaryWriter:
    def __init__(self, logdir="./log"):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        self._f = open(os.path.join(logdir, "scalars.jsonl"), "a")
        from ._tfevents import TFEventWriter

        self._tb = TFEventWriter(logdir)

    def add_scalar(self, tag, value, step=None, walltime=None):
        self._f.write(json.dumps({
            "tag": tag, "value": float(value), "step": step,
            "time": walltime or time.time(),
        }) + "\n")
        self._tb.add_scalar(tag, value, step, walltime)

    def add_scalars(self, main_tag, tag_scalar_dict, step=None):
        for k, v in tag_scalar_dict.items():
            self.add_scalar(f"{main_tag}/{k}", v, step)

    def add_text(self, tag, text, step=None):
        self._f.write(json.dumps({"tag": tag, "text": str(text), "step": step,
                                  "time": time.time()}) + "\n")

    def flush(self):
        self._f.flush()
        self._tb.flush()

    def close(self):
        try:
            self._f.flush()
            self._f.close()
        except ValueError:
            pass
        self._tb.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
