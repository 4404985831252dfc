"""Overflow observability for fixed-capacity sites.

Counterpart of the JAX package's ``utils/overflow.py``, with the same site
names. Every dynamic-size structure of the port is a fixed-capacity buffer
plus a validity mask; rows beyond a capacity are dropped deterministically
and counted here.

- ``record(name, count)`` is called at each capacity site with the number
  of dropped rows (a 0-d tensor, possibly on the card); ``gauge(name,
  value)`` with an occupancy value. Inside a ``capture()`` scope both are
  kept as tensors, with no host sync; outside one they are not kept.
- ``capture.counters()`` / ``capture.total()`` / ``capture.gauge_values()``
  read the scope's values (one host sync); ``capture.global_counters()``
  sums the counters over the ranks of the process group, where a run
  counts only if every rank dropped nothing (called by every rank).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

_CAPTURE_STACK: List['capture'] = []


class capture:
    """Collect the overflow counts and gauges of the code run inside the
    scope (the innermost open scope collects)."""

    def __enter__(self):
        self._items: List[Tuple[str, torch.Tensor]] = []
        self._gauges: List[Tuple[str, torch.Tensor]] = []
        _CAPTURE_STACK.append(self)
        return self

    def __exit__(self, *exc):
        _CAPTURE_STACK.remove(self)
        return False

    def counters(self) -> Dict[str, int]:
        """{site: dropped rows}, summed per site."""
        out: Dict[str, int] = {}
        for name, c in self._items:
            out[name] = out.get(name, 0) + int(c)
        return out

    def total(self) -> int:
        return sum(self.counters().values())

    def global_counters(self) -> Dict[str, int]:
        """``counters()`` summed per site over every rank of the process
        group (this process's without one)."""
        from ..parallel.distributed import collect_results
        out: Dict[str, int] = {}
        for _, counts in collect_results(self.counters()):
            for name, c in counts.items():
                out[name] = out.get(name, 0) + c
        return out

    def gauge_values(self) -> Dict[str, List[int]]:
        """{site: [value, ...]}, one entry per gauge() call, in call order."""
        out: Dict[str, List[int]] = {}
        for name, v in self._gauges:
            out.setdefault(name, []).append(int(v))
        return out


def _as_tensor(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach().to(torch.int64)
    return torch.tensor(int(value), dtype=torch.int64)


def record(name: str, count) -> None:
    """Count ``count`` dropped rows under ``name``."""
    if _CAPTURE_STACK:
        _CAPTURE_STACK[-1]._items.append((name, _as_tensor(count)))


def gauge(name: str, value) -> None:
    """Record an occupancy gauge (not a drop count)."""
    if _CAPTURE_STACK:
        _CAPTURE_STACK[-1]._gauges.append((name, _as_tensor(value)))
