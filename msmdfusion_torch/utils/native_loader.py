"""The native multi-sweep point loader, bound with ctypes.

Counterpart of the JAX package's ``utils/native_loader.py``: the same
C++ source, ``native/loader.cc`` (a thread pool reads the keyframe and
sweep ``.bin`` files, applies each file's sensor-to-LiDAR transform and
time channel, drops close sweep points and points out of range, and
writes fixed-capacity ``(points, mask)`` buffers), built here at first use
with the host's C++ compiler (``CXX``, default ``g++``) into
``msmdfusion_torch/_build/`` under a name that hashes the source and the
flags; the library checked in beside the source is never loaded. A build
that fails raises.

``load_sweeps`` runs the native loader; ``load_sweeps_plain`` is its
plain numpy version, which tests hold it against. A caller picks one by
calling it: neither stands in for the other.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / 'native' / 'loader.cc'
BUILD_DIR = Path(__file__).resolve().parents[1] / '_build'
FLAGS = ('-O3', '-march=native', '-std=c++17', '-fPIC', '-Wall', '-pthread',
         '-shared')

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    """Where the build of the current source and flags lives."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(' '.join(FLAGS).encode())
    return BUILD_DIR / f'libmsmd_loader_{digest.hexdigest()[:16]}.so'


def build() -> Path:
    """Compile ``native/loader.cc`` unless this source's build exists;
    returns the library's path. A failed compile raises with the
    compiler's output."""
    path = library_path()
    if path.is_file():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    try:
        out = subprocess.run(
            [os.environ.get('CXX', 'g++'), *FLAGS, '-o', tmp, str(SOURCE)],
            capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f'building {SOURCE} failed:\n{out.stderr}')
        os.replace(tmp, path)          # atomic: concurrent builds agree
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def _library():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            f = lib.msmd_load_sweeps
            f.restype = ctypes.c_int64
            f.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int64, ctypes.c_int]
            _lib = lib
    return _lib


def _checked(paths, transforms, time_deltas, load_dim, out_dim):
    if load_dim < 3 or out_dim < 4:
        raise ValueError(f'load_dim {load_dim} and out_dim {out_dim}: at '
                         'least xyz in, xyz and the time channel out')
    for p in paths:
        if not os.path.isfile(p):
            raise FileNotFoundError(p)
    transforms = np.ascontiguousarray(transforms, np.float32)
    deltas = np.ascontiguousarray(time_deltas, np.float32)
    if transforms.shape != (len(paths), 3, 4) or deltas.shape != (
            len(paths),):
        raise ValueError(f'{len(paths)} files, transforms '
                         f'{transforms.shape}, time deltas {deltas.shape}')
    return transforms, deltas


def load_sweeps(paths: Sequence[str], transforms: np.ndarray,
                time_deltas: Sequence[float], capacity: int,
                load_dim: int = 5, out_dim: int = 5,
                point_range: Optional[Sequence[float]] = None,
                remove_close: bool = True,
                num_threads: int = 4) -> Tuple[np.ndarray, np.ndarray]:
    """Keyframe and sweeps into fixed buffers, by the native loader.

    Args:
        paths: the ``.bin`` files (float32 rows of ``load_dim``), keyframe
            first.
        transforms: [len(paths), 3, 4] row-major [R|t], sensor to LiDAR.
        time_deltas: each file's time channel value.
        capacity: rows of the output; the files' points beyond it in file
            order are dropped.
        point_range: [x0, y0, z0, x1, y1, z1] kept (inclusive), or None.
        remove_close: drop sweep points (not the keyframe's) within 1 m of
            the sensor in BEV.
    Returns:
        (points [capacity, out_dim] float32: xyz, the input's channels
        3 .. out_dim - 2, the time delta last; mask [capacity] bool).
    """
    transforms, deltas = _checked(paths, transforms, time_deltas, load_dim,
                                  out_dim)
    lib = _library()
    points = np.zeros((capacity, out_dim), np.float32)
    mask = np.zeros((capacity,), np.uint8)
    c_paths = (ctypes.c_char_p * len(paths))(*[os.fsencode(p)
                                                for p in paths])
    fptr = ctypes.POINTER(ctypes.c_float)
    rng = None
    if point_range is not None:
        rng_arr = np.ascontiguousarray(point_range, np.float32)
        if rng_arr.shape != (6,):
            raise ValueError(f'point_range {point_range}')
        rng = rng_arr.ctypes.data_as(fptr)
    lib.msmd_load_sweeps(
        c_paths, transforms.ctypes.data_as(fptr), deltas.ctypes.data_as(fptr),
        len(paths), load_dim, out_dim, rng, int(remove_close),
        points.ctypes.data_as(fptr),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), capacity,
        num_threads)
    return points, mask.astype(bool)


def load_sweeps_plain(paths: Sequence[str], transforms: np.ndarray,
                      time_deltas: Sequence[float], capacity: int,
                      load_dim: int = 5, out_dim: int = 5,
                      point_range: Optional[Sequence[float]] = None,
                      remove_close: bool = True
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """``load_sweeps`` in numpy: the same arguments and result."""
    transforms, deltas = _checked(paths, transforms, time_deltas, load_dim,
                                  out_dim)
    points = np.zeros((capacity, out_dim), np.float32)
    written = 0
    for i, path in enumerate(paths):
        raw = np.fromfile(path, dtype=np.float32).reshape(-1, load_dim)
        if i > 0 and remove_close:
            raw = raw[raw[:, 0] * raw[:, 0] + raw[:, 1] * raw[:, 1] >= 1.0]
        xyz = raw[:, :3] @ transforms[i, :, :3].T + transforms[i, :, 3]
        if point_range is not None:
            pr = np.asarray(point_range, np.float32)
            keep = np.all((xyz >= pr[:3]) & (xyz <= pr[3:]), axis=1)
            raw, xyz = raw[keep], xyz[keep]
        take = min(len(raw), capacity - written)
        rows = points[written:written + take]
        rows[:, :3] = xyz[:take]
        extra = min(load_dim, out_dim - 1)
        rows[:, 3:extra] = raw[:take, 3:extra]
        rows[:, out_dim - 1] = deltas[i]
        written += take
    mask = np.zeros((capacity,), bool)
    mask[:written] = True
    return points, mask
