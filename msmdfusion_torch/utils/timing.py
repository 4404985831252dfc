"""Per-stage device time of a forward, by CUDA events.

``with section('plans'):`` brackets a part of the forward. Off by default
(no events, no cost). Inside ``record()`` every section on a CUDA device
records a start and an end event on the current stream; ``record.ms()``
synchronises once and returns {name: summed milliseconds}. Sections nest:
an outer section's time includes its inner ones.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch

_ACTIVE: List['record'] = []


class record:
    """Collect the sections run inside the scope on ``device``."""

    def __init__(self, device='cuda'):
        self.device = torch.device(device)
        self._events: List[Tuple[str, object, object]] = []

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
    try:
        yield
    finally:
        end.record()
        rec._events.append((name, start, end))
