"""Dependency-free TensorBoard scalar event writer (a copy of the JAX
package's ``utils/tb_writer.py``, which imports no JAX; the bytes it writes
are that module's for the same scalars and wall time).

The reference recipe reports scalars to TensorBoard every step by default
(``--report_to tensorboard``, run_train.sh:34, logging_steps 1 at :28). This
module encodes the TFRecord framing and the tiny subset of the
``Event``/``Summary`` protobufs that scalars need by hand, writes
synchronously from the calling thread (no forked writer process), and needs
no tensorflow/tensorboardX import. Output is readable by stock TensorBoard
(``tensorboard --logdir ...``).

Wire format:
  record  = uint64 len | uint32 masked_crc32c(len) | data | masked_crc32c(data)
  Event   = 1: double wall_time | 2: int64 step | 3: string file_version
            | 5: Summary summary
  Summary = repeated 1: Value { 1: string tag | 2: float simple_value }
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict

# --- crc32c (Castagnoli), table-driven ------------------------------------

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# --- minimal protobuf encoding ---------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field_double(num: int, v: float) -> bytes:
    return bytes([num << 3 | 1]) + struct.pack("<d", v)


def _field_float(num: int, v: float) -> bytes:
    return bytes([num << 3 | 5]) + struct.pack("<f", v)


def _field_varint(num: int, v: int) -> bytes:
    return bytes([num << 3]) + _varint(v)


def _field_bytes(num: int, v: bytes) -> bytes:
    return bytes([num << 3 | 2]) + _varint(len(v)) + v


def _scalar_event(step: int, wall_time: float, scalars: Dict[str, float]) -> bytes:
    summary = b"".join(
        _field_bytes(
            1,
            _field_bytes(1, tag.encode()) + _field_float(2, float(v)),
        )
        for tag, v in scalars.items()
    )
    return (
        _field_double(1, wall_time)
        + _field_varint(2, step)
        + _field_bytes(5, summary)
    )


def _version_event(wall_time: float) -> bytes:
    return _field_double(1, wall_time) + _field_bytes(3, b"brain.Event:2")


class ScalarEventWriter:
    """Synchronous TensorBoard scalar writer (no threads, no fork)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        name = "events.out.tfevents.%010d.%s" % (time.time(), socket.gethostname())
        self._f = open(os.path.join(log_dir, name), "ab")
        self._write_record(_version_event(time.time()))

    def _write_record(self, data: bytes) -> None:
        header = struct.pack("<Q", len(data))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(data)
        self._f.write(struct.pack("<I", _masked_crc(data)))
        self._f.flush()

    def add_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        if scalars:
            self._write_record(_scalar_event(step, time.time(), scalars))

    def close(self) -> None:
        self._f.close()
