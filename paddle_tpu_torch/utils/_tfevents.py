"""Minimal TensorBoard event-file writer (counterpart of
``paddle_tpu/utils/_tfevents.py``, copied: pure Python, no TF or
tensorboard dependency).

Hand-encodes the two protos scalar logging needs (Event{wall_time, step,
summary} and Summary{value{tag, simple_value}}) and frames them in the
TFRecord format (length + masked crc32c of length, payload, masked crc32c
of payload).  TensorBoard reads the result.
"""

from __future__ import annotations

import os
import socket
import struct
import time

# ----------------------------------------------------------------- crc32c
_CRC_TABLE = []


def _build_table():
    poly = 0x82F63B78
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        _CRC_TABLE.append(c)


_build_table()


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF)


# ------------------------------------------------------------ protobuf bits
def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def _field_double(num: int, v: float) -> bytes:
    return _varint((num << 3) | 1) + struct.pack("<d", v)


def _field_float(num: int, v: float) -> bytes:
    return _varint((num << 3) | 5) + struct.pack("<f", v)


def _field_varint(num: int, v: int) -> bytes:
    return _varint(num << 3) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _scalar_event(tag: str, value: float, step: int, wall: float) -> bytes:
    val = (_field_bytes(1, tag.encode("utf-8"))       # Summary.Value.tag
           + _field_float(2, float(value)))           # .simple_value
    summary = _field_bytes(1, val)                    # Summary.value (rep.)
    return (_field_double(1, wall)                    # Event.wall_time
            + _field_varint(2, int(step or 0))        # Event.step
            + _field_bytes(5, summary))               # Event.summary


def _version_event(wall: float) -> bytes:
    return (_field_double(1, wall)
            + _field_bytes(3, b"brain.Event:2"))      # Event.file_version


class TFEventWriter:
    """Appends TFRecord-framed Event protos to one tfevents file."""

    _SEQ = [0]  # per-process uniquifier: two writers in the same second
    # must not interleave records into one file (CRC framing would break)

    def __init__(self, logdir):
        os.makedirs(logdir, exist_ok=True)
        TFEventWriter._SEQ[0] += 1
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{socket.gethostname()}.{os.getpid()}"
                 f".{TFEventWriter._SEQ[0]}")
        self._f = open(os.path.join(logdir, fname), "ab")
        self._write(_version_event(time.time()))

    def _write(self, payload: bytes):
        header = struct.pack("<Q", len(payload))
        self._f.write(header + struct.pack("<I", _masked_crc(header))
                      + payload + struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag, value, step=None, walltime=None):
        self._write(_scalar_event(tag, value, step,
                                  walltime or time.time()))

    def flush(self):
        self._f.flush()

    def close(self):
        try:
            self._f.flush()
            self._f.close()
        except Exception:
            pass
