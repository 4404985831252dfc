"""Summarize a ``torch.profiler`` trace: device kernels by self time, and
their sums per scope.

Counterpart of the JAX package's ``tools/analysis_tools/trace_summary.py``,
which reads XLA's xplanes through xprof; this one reads the Chrome trace
that ``utils/profiling.trace`` writes (``*.pt.trace.json``, or any
``torch.profiler`` ``export_chrome_trace`` file).

    python -m msmdfusion_torch.tools.analysis_tools.trace_summary \\
        TRACE_DIR_OR_FILE [-n 40] [--scope-depth 3] [--iters N] \\
        [--device cuda]

- Device time: the trace's kernel, memcpy and memset events (categories
  ``kernel``, ``gpu_memcpy``, ``gpu_memset``), each its own self time.
- Top ops: summed over the events of one name, with their occurrences.
- Scopes: each device event belongs to the ``record_function`` ranges
  (``profiling.named_scope``; every ``utils/timing.section``) that enclose
  the host call that launched it (matched by the events' ``correlation``),
  outermost first, joined by ``/`` and cut at ``--scope-depth``; ``(top)``
  where none does.
- ``--iters`` (default: the occurrences of the detector's top-level scope
  ``extract_pts_feat``, as the JAX tool counts its ``extract_pts_feat``,
  at least 1) divides every total.

It reads files only; like every entry point of the port it stops on a
machine with no card unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import bisect
import glob
import gzip
import json
import os
import sys
from collections import defaultdict
from typing import Dict, List, Optional

from .. import add_device, device_of

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
LAUNCH_CATS = ('cuda_runtime', 'cuda_driver')
SCOPE_CAT = 'user_annotation'
TOP_SCOPE = 'extract_pts_feat'


def find_trace(path: str) -> str:
    """``path``, or the newest Chrome trace under the directory ``path``."""
    if os.path.isfile(path):
        return path
    hits = [p for pattern in ('*.json', '*.json.gz') for p in glob.glob(
        os.path.join(path, '**', pattern), recursive=True)]
    if not hits:
        sys.exit(f'no Chrome trace (*.json) under {path}')
    return max(hits, key=os.path.getmtime)


def load_events(path: str) -> List[Dict]:
    opener = gzip.open if path.endswith('.gz') else open
    with opener(path, 'rt') as f:
        data = json.load(f)
    return data['traceEvents'] if isinstance(data, dict) else data


def scope_of(path: List[str], depth: int) -> str:
    return '/'.join(path[:depth]) or '(top)'


def device_rows(events: List[Dict]) -> List[Dict]:
    """The device events, each with ``scopes``: the names of the ranges
    enclosing its launch, outermost first."""
    ranges = defaultdict(list)        # (pid, tid) -> [(start, end, name)]
    launches = {}                     # correlation -> (pid, tid, ts)
    for e in events:
        if e.get('ph') != 'X':
            continue
        if e.get('cat') == SCOPE_CAT:
            ranges[e['pid'], e['tid']].append(
                (float(e['ts']), float(e['ts']) + float(e.get('dur', 0)),
                 e['name']))
        elif e.get('cat') in LAUNCH_CATS and 'correlation' in e.get(
                'args', {}):
            launches[e['args']['correlation']] = (e['pid'], e['tid'],
                                                  float(e['ts']))
    # by start, and where two start together the longer (outer) first
    ranges = {k: sorted(v, key=lambda r: (r[0], -r[1]))
              for k, v in ranges.items()}
    starts = {k: [r[0] for r in v] for k, v in ranges.items()}
    rows = []
    for e in events:
        if e.get('ph') != 'X' or e.get('cat') not in DEVICE_CATS:
            continue
        scopes = []
        launch = launches.get(e.get('args', {}).get('correlation'))
        if launch is not None:
            pid, tid, ts = launch
            key = (pid, tid)
            if key in ranges:
                # the ranges that start before the launch, outermost first
                # (an enclosing range starts earlier and ends later)
                before = ranges[key][:bisect.bisect_right(starts[key], ts)]
                scopes = [name for start, end, name in before if ts < end]
        rows.append(dict(name=e['name'], cat=e['cat'],
                         dur_us=float(e.get('dur', 0)), scopes=scopes))
    return rows


def summarize(events: List[Dict], depth: int = 3,
              iters: int = 0) -> Dict:
    """dict(total_ms, iters, ops: [(ms, occurrences, cat, name)] by ms
    descending, scopes: {scope: ms}), totals over the trace (not per
    iteration)."""
    rows = device_rows(events)
    if not iters:
        iters = max(1, sum(1 for e in events if e.get('ph') == 'X'
                           and e.get('cat') == SCOPE_CAT
                           and e['name'] == TOP_SCOPE))
    ops = defaultdict(lambda: [0.0, 0, ''])
    scopes = defaultdict(float)
    for r in rows:
        op = ops[r['name']]
        op[0] += r['dur_us'] / 1e3
        op[1] += 1
        op[2] = r['cat']
        scopes[scope_of(r['scopes'], depth)] += r['dur_us'] / 1e3
    ranked = sorted(((ms, n, cat, name) for name, (ms, n, cat)
                     in ops.items()), key=lambda t: -t[0])
    return dict(total_ms=sum(r['dur_us'] for r in rows) / 1e3, iters=iters,
                ops=ranked, scopes=dict(scopes))


def main(argv: Optional[List[str]] = None) -> Dict:
    """Print the summary; returns ``summarize``'s dict."""
    ap = argparse.ArgumentParser()
    ap.add_argument('path', help='trace dir or Chrome trace file')
    ap.add_argument('-n', type=int, default=40, help='rows to print')
    ap.add_argument('--scope-depth', type=int, default=3)
    ap.add_argument('--iters', type=int, default=0,
                    help='divide totals by this many traced steps')
    add_device(ap, 'nothing (the tool reads files)')
    args = ap.parse_args(argv)
    device_of(args)

    out = summarize(load_events(find_trace(args.path)), args.scope_depth,
                    args.iters)
    iters = out['iters']
    print(f'device self-time total: {out["total_ms"]:.1f} ms '
          f'({out["total_ms"] / iters:.1f} ms/iter over {iters} iters)\n')

    print(f'=== top {args.n} ops by device self-time ===')
    for ms, n, cat, name in out['ops'][:args.n]:
        if len(name) > 100:
            name = '...' + name[-97:]
        print(f'{ms / iters:9.3f} ms/iter x{n:<4d} {cat:<22s} {name}')

    print(f'\n=== scopes (depth {args.scope_depth}) ===')
    for k, v in sorted(out['scopes'].items(),
                       key=lambda kv: -kv[1])[:args.n]:
        print(f'{v / iters:9.3f} ms/iter  {k}')
    return out


if __name__ == '__main__':
    main()
