"""Per-stage device time of a forward, by CUDA events.

``with section('plans'):`` brackets a part of the forward. Off by default
(no events, no cost). Inside ``record()`` every section on a CUDA device
records a start and an end event on the current stream; ``record.ms()``
synchronises once and returns {name: summed milliseconds}. Sections nest:
an outer section's time includes its inner ones. ``record.host_ms()``
gives the same sums by the host's clock: the time the host spent issuing
each section's work, which the events do not show while the device runs
behind the host (the stream then reaches a section's start event late and
runs through its work at the device's pace).
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

import torch

_ACTIVE: List['record'] = []


class record:
    """Collect the sections run inside the scope on ``device``."""

    def __init__(self, device='cuda'):
        self.device = torch.device(device)
        self._events: List[Tuple[str, object, object]] = []
        self._host: Dict[str, float] = {}

    def __enter__(self):
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return False

    def ms(self) -> Dict[str, float]:
        torch.cuda.synchronize(self.device)
        out: Dict[str, float] = {}
        for name, start, end in self._events:
            out[name] = out.get(name, 0.0) + start.elapsed_time(end)
        return out

    def host_ms(self) -> Dict[str, float]:
        return dict(self._host)


def _current() -> Optional[record]:
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def section(name: str):
    rec = _current()
    if rec is None or rec.device.type != 'cuda':
        yield
        return
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        end.record()
        rec._events.append((name, start, end))
        rec._host[name] = rec._host.get(name, 0.0) + \
            (time.perf_counter() - t0) * 1e3
