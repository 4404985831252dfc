"""Waymo-format prediction serialization (``metrics_pb2.Objects`` .bin).

Counterpart of the JAX package's ``core/evaluation/waymo_serialize.py``,
copied.

The reference converts KITTI-format predictions into the waymo-open-
dataset ``Objects`` proto and shells out to the compiled WOD metrics
binary (mmdet3d/core/evaluation/waymo_utils/prediction_kitti_to_waymo.py
:100-230 ``parse_objects``, :261 ``convert``; datasets/waymo_dataset.py
:279-350). The in-tree metric here stays the native L1/L2 proxy
(waymo_eval.py), but this module closes the *format* gap: it emits the
same combined ``.bin`` file (``waymo_results_final_path``) a Waymo
evaluation server / the official devkit consumes, so the proxy numbers
can be cross-checked externally.

No protobuf dependency: the two tiny messages are hand-encoded on the
protobuf wire format (varint tags, length-delimited submessages) from
the PUBLIC stable field numbering of waymo-open-dataset:

``label.proto``::

    message Label {
      message Box { double center_x=1; center_y=2; center_z=3;
                    length=4; width=5; height=6; heading=7; }
      Box box = 1;
      enum Type { UNKNOWN=0; VEHICLE=1; PEDESTRIAN=2; SIGN=3; CYCLIST=4; }
      Type type = 3;
      string id = 4;
    }

``metrics.proto``::

    message Object  { Label object=1; float score=2;
                      bool overlap_with_nlz=3; string context_name=4;
                      int64 frame_timestamp_micros=5; }
    message Objects { repeated Object objects = 1; }

Box conversion: this framework's boxes are LiDAR/vehicle-frame
``[x, y, z, dx, dy, dz, yaw]`` with BOTTOM-center origin (core/boxes.py)
— the same frame Waymo uses, so unlike the reference (whose intermediate
is the KITTI camera frame, hence its axis swap + ``-(ry + pi/2)`` heading
juggling) the conversion is just the bottom->true center z shift.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence

import numpy as np

# Label.Type values (label.proto)
TYPE_UNKNOWN, TYPE_VEHICLE, TYPE_PEDESTRIAN, TYPE_SIGN, TYPE_CYCLIST = range(5)

# class-name -> Label.Type (reference k2w_cls_map,
# prediction_kitti_to_waymo.py:60-66)
K2W_CLS_MAP = {
    'Car': TYPE_VEHICLE, 'Vehicle': TYPE_VEHICLE, 'car': TYPE_VEHICLE,
    'Pedestrian': TYPE_PEDESTRIAN, 'pedestrian': TYPE_PEDESTRIAN,
    'Sign': TYPE_SIGN, 'sign': TYPE_SIGN,
    'Cyclist': TYPE_CYCLIST, 'cyclist': TYPE_CYCLIST,
}


def _varint(v: int) -> bytes:
    out = bytearray()
    v &= (1 << 64) - 1
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _double(field: int, v: float) -> bytes:
    return _tag(field, 1) + struct.pack('<d', float(v))


def _float(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack('<f', float(v))


def _int(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(int(v))


def _bytes(field: int, b: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(b)) + b


def encode_box(box7: Sequence[float]) -> bytes:
    """LiDAR-frame bottom-center [x, y, z, dx, dy, dz, yaw] -> Label.Box."""
    x, y, z, dx, dy, dz, yaw = (float(v) for v in box7[:7])
    heading = float(np.mod(yaw + np.pi, 2 * np.pi) - np.pi)
    return (_double(1, x) + _double(2, y) + _double(3, z + dz / 2)
            + _double(4, dx) + _double(5, dy) + _double(6, dz)
            + _double(7, heading))


def encode_object(box7, score: float, obj_type: int, context_name: str,
                  timestamp_micros: int) -> bytes:
    label = _bytes(1, encode_box(box7)) + _int(3, obj_type)
    return (_bytes(1, label) + _float(2, score)
            + _bytes(4, context_name.encode('utf-8'))
            + _int(5, timestamp_micros))


def serialize_waymo_objects(results: List[Dict[str, np.ndarray]],
                            contexts: Optional[List[Dict]] = None,
                            classes: Sequence[str] = ('Car', 'Pedestrian',
                                                      'Cyclist')) -> bytes:
    """Combined ``Objects`` bin for per-frame detection results.

    results[i]: dict(bboxes [N, 7+], scores [N], labels [N]) — the
    tools/test.py result layout. contexts[i] (optional): dict with
    ``context_name`` / ``timestamp_micros`` from the frame info.
    """
    out = bytearray()
    for i, res in enumerate(results):
        ctx = (contexts[i] if contexts else {}) or {}
        name = str(ctx.get('context_name', f'context_{i}'))
        ts = int(ctx.get('timestamp_micros', i))
        boxes = np.asarray(res['bboxes'], np.float64)
        scores = np.asarray(res['scores'], np.float64)
        labels = np.asarray(res['labels'], np.int64)
        for j in range(len(boxes)):
            cls = classes[int(labels[j])] if 0 <= labels[j] < len(classes) \
                else 'Car'
            obj = encode_object(boxes[j], scores[j],
                                K2W_CLS_MAP.get(cls, TYPE_UNKNOWN), name, ts)
            out += _bytes(1, obj)
    return bytes(out)


# ---------------------------------------------------------------------------
# Minimal wire-format decoder (tests / external cross-checks without the
# waymo devkit installed)
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int):
    shift = v = 0
    while True:
        b = buf[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, pos
        shift += 7


def decode_fields(buf: bytes):
    """[(field, wire, value)] — raw protobuf fields of one message."""
    pos, out = 0, []
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, pos = _read_varint(buf, pos)
        elif wire == 1:
            v = struct.unpack('<d', buf[pos:pos + 8])[0]
            pos += 8
        elif wire == 5:
            v = struct.unpack('<f', buf[pos:pos + 4])[0]
            pos += 4
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            v = buf[pos:pos + ln]
            pos += ln
        else:  # pragma: no cover - groups unused
            raise ValueError(f'wire type {wire}')
        out.append((field, wire, v))
    return out


def parse_objects_bin(buf: bytes) -> List[Dict]:
    """Decode a serialized Objects bin back into python dicts."""
    objs = []
    for field, wire, payload in decode_fields(buf):
        if field != 1 or wire != 2:
            continue
        o: Dict = {}
        for f2, w2, v2 in decode_fields(payload):
            if f2 == 1:                       # Label
                for f3, w3, v3 in decode_fields(v2):
                    if f3 == 1:               # Box
                        box = {f4: v4 for f4, _, v4 in decode_fields(v3)}
                        o['box'] = [box.get(k, 0.0) for k in range(1, 8)]
                    elif f3 == 3:
                        o['type'] = v3
            elif f2 == 2:
                o['score'] = v2
            elif f2 == 4:
                o['context_name'] = v2.decode('utf-8')
            elif f2 == 5:
                o['frame_timestamp_micros'] = v2
        objs.append(o)
    return objs
