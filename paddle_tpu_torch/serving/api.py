"""Deployment-facing surface of the serving engine (counterpart of
``paddle_tpu/serving/api.py``).

:class:`ContinuousBatchingPredictor` puts the ``paddle.inference``
Predictor shape (named input/output handles, ``copy_from_cpu`` / ``run()``
/ ``copy_to_cpu``) over a :class:`~.engine.ServingEngine`: every row of the
staged ``input_ids`` batch becomes an independent request, so concurrent
``run()`` callers, and the rows within one call, share the engine's
iteration-level batch.
"""

from __future__ import annotations

import numpy as np

from .engine import ServingEngine


class PredictorTensor:
    """Named host-side staging buffer (``paddle.inference.Tensor`` shape;
    a copy of the TPU package's ``inference.PredictorTensor``)."""

    def __init__(self, name, spec_shape=None, dtype=None):
        self._name = name
        self._spec_shape = spec_shape
        self._dtype = dtype
        self._value = None

    def name(self):
        return self._name

    def reshape(self, shape):
        if self._value is not None:
            self._value = np.reshape(self._value, shape)
        else:
            self._spec_shape = list(shape)

    def copy_from_cpu(self, arr):
        self._value = np.ascontiguousarray(arr)

    def copy_to_cpu(self):
        return None if self._value is None else np.asarray(self._value)

    def shape(self):
        if self._value is not None:
            return list(self._value.shape)
        return list(self._spec_shape or [])

    def type(self):
        return str(self._dtype)


class ContinuousBatchingPredictor:
    """Predictor-shaped facade over a :class:`ServingEngine`.

    Input handle ``input_ids``: int64 ``[B, S]``, rows right-padded with
    ``pad_token_id``.  Output handle ``output_0``: int64
    ``[B, S + max_new_tokens]`` — prompt + generated ids, right-padded.
    ``engine_kwargs`` (``device=``, ``num_slots=``, ...) build the engine;
    like it, the predictor runs on the card unless ``device="cpu"``.  A
    given ``engine`` is used as is.  ``config`` (an inference ``Config``)
    is recorded, as the reference records it.
    """

    def __init__(self, model, config=None, max_new_tokens=32,
                 temperature=0.0, eos_token_id=None, pad_token_id=0,
                 engine=None, **engine_kwargs):
        self._engine = engine if engine is not None \
            else ServingEngine(model, **engine_kwargs)
        self._config = config
        self._max_new_tokens = int(max_new_tokens)
        self._temperature = float(temperature)
        self._eos = eos_token_id
        self._pad = int(pad_token_id)
        self._input = PredictorTensor("input_ids", [None, None], "int64")
        self._output = PredictorTensor("output_0", None, "int64")

    def get_input_names(self):
        return ["input_ids"]

    def get_input_handle(self, name):
        if name != "input_ids":
            raise KeyError(f"unknown input {name!r}; valid: ['input_ids']")
        return self._input

    def get_output_names(self):
        return ["output_0"]

    def get_output_handle(self, name):
        if name != "output_0":
            raise KeyError(f"unknown output {name!r}; valid: ['output_0']")
        return self._output

    def run(self, inputs=None):
        """Fan the staged batch out as one request per row, wait for all,
        refill the output handle.  ``run([ids_batch])`` returns
        ``[np.ndarray]`` like the reference."""
        if inputs is not None:
            if len(inputs) != 1:
                raise ValueError(f"run() takes one input batch, "
                                 f"got {len(inputs)}")
            self._input.copy_from_cpu(np.asarray(inputs[0]))
        ids = self._input.copy_to_cpu()
        if ids is None or ids.ndim != 2:
            raise RuntimeError("input_ids not set (or not [B, S]); call "
                               "copy_from_cpu first")
        ids = ids.astype(np.int64)
        handles = []
        try:
            for row in ids:
                # strip TRAILING padding only (pad_token_id may be a real
                # token mid-prompt); all-pad rows keep one token
                nz = np.nonzero(row != self._pad)[0]
                prompt = row[:nz[-1] + 1] if nz.size else row[:1]
                handles.append(self._engine.submit(
                    prompt, max_new_tokens=self._max_new_tokens,
                    temperature=self._temperature, eos_token_id=self._eos))
        except Exception:
            # a mid-batch rejection must not leave earlier rows decoding
            # unobserved
            for h in handles:
                h.cancel()
            raise
        B, S = ids.shape
        out = np.full((B, S + self._max_new_tokens), self._pad, np.int64)
        out[:, :S] = ids
        for b, h in enumerate(handles):
            new = h.result()
            out[b, S:S + len(new)] = new
        self._output.copy_from_cpu(out)
        if inputs is not None:
            return [out.copy()]
        return True

    def submit(self, prompt_ids, **kw):
        kw.setdefault("max_new_tokens", self._max_new_tokens)
        kw.setdefault("temperature", self._temperature)
        kw.setdefault("eos_token_id", self._eos)
        return self._engine.submit(prompt_ids, **kw)

    def stream(self, prompt_ids, **kw):
        return self.submit(prompt_ids, **kw).stream()

    @property
    def engine(self):
        return self._engine

    def close(self):
        self._engine.stop()

    def __enter__(self):
        self._engine.start()
        return self

    def __exit__(self, *exc):
        self.close()
