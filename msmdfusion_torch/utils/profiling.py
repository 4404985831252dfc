"""Profiling and timing utilities.

Counterpart of the JAX package's ``utils/profiling.py`` (reference: the
wall-clock probes of tools/analysis_tools/benchmark.py:63-100):

- ``trace(log_dir)``: ``torch.profiler`` with CPU and (on a machine with a
  card) CUDA activities around a block; on exit the Chrome trace is
  written into ``log_dir`` as ``<host>_<pid>.<ms>.pt.trace.json``, the
  input of ``tools/analysis_tools/trace_summary.py``;
- ``named_scope(name)``: a ``torch.profiler.record_function`` range while
  a profiler runs (nothing otherwise, so the scopes cost nothing outside
  a trace); ``utils/timing.section`` opens one for each stage;
- ``time_fn``: min/median/mean/max seconds of a function, by CUDA events
  around each call on the card, by the host clock on the CPU;
- ``flops_estimate``: ``apis.flops_counter.count_flops``' FLOP.
"""
from __future__ import annotations

import contextlib
import os
import socket
import time
from typing import Callable, Dict

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler


@contextlib.contextmanager
def trace(log_dir: str = 'torch_trace'):
    """Capture a profiler trace around a block; yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    name = (f'{socket.gethostname()}_{os.getpid()}.'
            f'{int(time.time() * 1e3)}.pt.trace.json')
    prof.export_chrome_trace(os.path.join(log_dir, name))


def named_scope(name: str):
    """A range named ``name`` in the trace of any running profiler (the
    counterpart of ``jax.named_scope``): ``trace_summary`` sums the device
    time of the kernels launched inside it."""
    if getattr(_autograd_profiler, '_is_profiler_enabled', True):
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def _on_card(tree) -> bool:
    if isinstance(tree, torch.Tensor):
        return tree.is_cuda
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_on_card(x) for x in tree)
    return False


def time_fn(fn: Callable, *args, iters: int = 20, warmup: int = 3,
            percentile: str = 'min') -> Dict[str, float]:
    """Seconds of ``fn(*args)``: {min_s, median_s, mean_s, max_s} over
    ``iters`` calls after ``warmup``. Where an argument or the output lies
    on the card, each call is timed by CUDA events around it (the device's
    time from the call's first launch to its last op), else by the host
    clock. ``percentile`` is kept for the JAX signature: every statistic
    is returned."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    card = _on_card(args) or _on_card(out)
    times = []
    if card:
        torch.cuda.synchronize()
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            fn(*args)
            times.append(time.perf_counter() - t0)
    arr = np.asarray(times)
    return {'min_s': float(arr.min()), 'median_s': float(np.median(arr)),
            'mean_s': float(arr.mean()), 'max_s': float(arr.max())}


def flops_estimate(fn: Callable, *args) -> float:
    """FLOP of one call of ``fn(*args)`` (``count_flops``); errors raise."""
    from ..apis.flops_counter import count_flops
    return float(count_flops(fn, *args)['flops'])
