"""Dependency-free TensorBoard event-file writer.

Private copy of the JAX package's ``utils/tb_writer.py``. The reference's ``log_config`` enables mmcv's ``TensorboardLoggerHook``
alongside the text logger (configs/MSMDFusion_nusc_voxel_LC.py:296-299).
This module closes that gap without pulling in tensorflow/tensorboardX:
it hand-encodes the two tiny protobuf messages TensorBoard's scalar
dashboard needs (``Event``/``Summary``) and frames them in the TFRecord
format (length + masked CRC32C), producing standard
``events.out.tfevents.*`` files readable by TensorBoard.

Wire format (stable public TF contracts):
- TFRecord: ``uint64 len | uint32 masked_crc(len) | bytes | uint32
  masked_crc(bytes)`` with CRC32C (Castagnoli) and TF's rotate+add mask.
- Event proto: field 1 ``wall_time`` (double), field 2 ``step`` (int64),
  field 3 ``file_version`` (string, first record only, "brain.Event:2"),
  field 5 ``summary`` (message).
- Summary proto: repeated field 1 ``value``; Value: field 1 ``tag``
  (string), field 2 ``simple_value`` (float).
"""
from __future__ import annotations

import itertools
import os
import socket
import struct
import time
from typing import Dict, Optional

_WRITER_SEQ = itertools.count()

# ---- CRC32C (Castagnoli, reflected poly 0x82F63B78), table-driven ----
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


# ---- minimal protobuf encoding ----
def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1  # int64 two's complement
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def _encode_value(tag: str, value: float) -> bytes:
    return (_field_bytes(1, tag.encode()) +
            _varint((2 << 3) | 5) + struct.pack('<f', float(value)))


def _encode_event(wall_time: float, step: int,
                  scalars: Optional[Dict[str, float]] = None,
                  file_version: Optional[str] = None) -> bytes:
    ev = _varint((1 << 3) | 1) + struct.pack('<d', wall_time)
    ev += _varint((2 << 3) | 0) + _varint(int(step))
    if file_version is not None:
        ev += _field_bytes(3, file_version.encode())
    if scalars:
        summary = b''.join(_field_bytes(1, _encode_value(t, v))
                           for t, v in scalars.items())
        ev += _field_bytes(5, summary)
    return ev


def _frame_record(data: bytes) -> bytes:
    header = struct.pack('<Q', len(data))
    return (header + struct.pack('<I', _masked_crc(header)) + data +
            struct.pack('<I', _masked_crc(data)))


def read_events(path: str):
    """Parse an event file back into (step, {tag: value}) records.

    Round-trip check used by the tests; also handy for analyze_logs on
    TB-only run dirs.
    """
    records = []
    with open(path, 'rb') as f:
        blob = f.read()
    off = 0
    while off < len(blob):
        (length,) = struct.unpack_from('<Q', blob, off)
        header = blob[off:off + 8]
        (hcrc,) = struct.unpack_from('<I', blob, off + 8)
        assert hcrc == _masked_crc(header), 'corrupt length crc'
        data = blob[off + 12:off + 12 + length]
        (dcrc,) = struct.unpack_from('<I', blob, off + 12 + length)
        assert dcrc == _masked_crc(data), 'corrupt data crc'
        off += 12 + length + 4
        records.append(_decode_event(data))
    return records


def _decode_event(data: bytes):
    step, scalars = 0, {}
    pos = 0
    while pos < len(data):
        key, pos = _read_varint(data, pos)
        num, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(data, pos)
            if num == 2:
                step = val
        elif wire == 1:
            pos += 8
        elif wire == 5:
            pos += 4
        elif wire == 2:
            ln, pos = _read_varint(data, pos)
            payload = data[pos:pos + ln]
            pos += ln
            if num == 5:  # summary
                scalars.update(_decode_summary(payload))
    return step, scalars


def _decode_summary(data: bytes):
    scalars = {}
    pos = 0
    while pos < len(data):
        key, pos = _read_varint(data, pos)
        ln, pos = _read_varint(data, pos)
        value = data[pos:pos + ln]
        pos += ln
        if key >> 3 == 1:
            tag, simple = None, None
            vp = 0
            while vp < len(value):
                vkey, vp = _read_varint(value, vp)
                if vkey >> 3 == 1 and vkey & 7 == 2:
                    vln, vp = _read_varint(value, vp)
                    tag = value[vp:vp + vln].decode()
                    vp += vln
                elif vkey >> 3 == 2 and vkey & 7 == 5:
                    (simple,) = struct.unpack_from('<f', value, vp)
                    vp += 4
                else:  # skip unknown
                    if vkey & 7 == 0:
                        _, vp = _read_varint(value, vp)
                    elif vkey & 7 == 2:
                        vln, vp = _read_varint(value, vp)
                        vp += vln
                    elif vkey & 7 == 5:
                        vp += 4
                    else:
                        vp += 8
            if tag is not None and simple is not None:
                scalars[tag] = simple
    return scalars


def _read_varint(data: bytes, pos: int):
    result = shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


class TensorboardEventWriter:
    """Scalar event writer with the same ``write`` signature as
    ``JsonLogWriter`` so the train CLI can fan out to both."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        host = socket.gethostname()
        # pid + monotonic counter uniquify the name: two writers created
        # within the same second must not truncate each other
        suffix = f'{os.getpid()}.{next(_WRITER_SEQ)}'
        self.path = os.path.join(
            log_dir, f'events.out.tfevents.{int(time.time())}.{host}.{suffix}')
        with open(self.path, 'wb') as f:
            f.write(_frame_record(_encode_event(
                time.time(), 0, file_version='brain.Event:2')))

    def write(self, mode: str, epoch: int, step: int,
              scalars: Dict[str, float], **extra) -> None:
        tagged = {}
        for k, v in {**scalars, **extra}.items():
            if hasattr(v, '__float__') or isinstance(v, (int, float)):
                tagged[f'{mode}/{k}'] = float(v)
        if not tagged:
            return
        with open(self.path, 'ab') as f:
            f.write(_frame_record(_encode_event(time.time(), step, tagged)))
