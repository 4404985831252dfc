"""Training-log analysis: loss curves and a throughput summary.

Counterpart of the JAX package's ``tools/analysis_tools/analyze_logs.py``
(reference tools/analysis_tools/analyze_logs.py), copied: it reads the
logs the port's train CLI writes (``python -m msmdfusion_torch.tools.train``:
``<work_dir>/<time>.log.json``, ``utils/log_hooks.JsonLogWriter``, and
``<work_dir>/train.log``'s ``step N/M R samples/s key=value ...`` lines)
and prints, or plots with ``--out``, the same summary.

    python -m msmdfusion_torch.tools.analysis_tools.analyze_logs LOG ... \
        [--keys total_loss ...] [--out curves.png] [--device cuda]

It reads files only; like every entry point of the port it stops on a
machine with no card unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import re
from collections import defaultdict
from typing import List, Optional

from .. import add_device, device_of


def parse_log(path):
    """Parse either a .log.json line-JSON scalar log (mmcv TextLoggerHook
    format, written by utils/log_hooks.JsonLogWriter) or the plain
    train.log "key=value" lines."""
    metrics = defaultdict(list)
    steps = []
    if path.endswith('.json'):
        import json
        for line in open(path):
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if rec.get('mode') != 'train':
                continue
            steps.append(int(rec.get('iter', 0)))
            for k, v in rec.items():
                if isinstance(v, (int, float)) and k not in ('iter', 'epoch'):
                    metrics[k].append(float(v))
        return steps, metrics
    pattern = re.compile(r'step (\d+)/\d+ ([\d.]+) samples/s (.*)')
    for line in open(path):
        m = pattern.search(line)
        if not m:
            continue
        steps.append(int(m.group(1)))
        metrics['samples_per_s'].append(float(m.group(2)))
        for kv in m.group(3).split():
            if '=' in kv:
                k, v = kv.split('=', 1)
                try:
                    metrics[k].append(float(v))
                except ValueError:
                    pass
    return steps, metrics


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument('logs', nargs='+')
    p.add_argument('--keys', nargs='+', default=['total_loss'])
    p.add_argument('--out', default=None, help='PNG path (omit to print)')
    add_device(p, 'nothing (the tool reads files)')
    args = p.parse_args(argv)
    device_of(args)

    for path in args.logs:
        steps, metrics = parse_log(path)
        if not steps:
            print(f'{path}: no metric lines found')
            continue
        print(f'{path}: {len(steps)} entries, '
              f'mean throughput {sum(metrics["samples_per_s"]) / max(len(metrics["samples_per_s"]), 1):.1f} samples/s')
        for key in args.keys:
            if metrics.get(key):
                vals = metrics[key]
                print(f'  {key}: first {vals[0]:.4f} last {vals[-1]:.4f} '
                      f'min {min(vals):.4f}')
        if args.out:
            import matplotlib
            matplotlib.use('Agg')
            import matplotlib.pyplot as plt
            fig, ax = plt.subplots()
            for key in args.keys:
                if metrics.get(key):
                    ax.plot(steps[:len(metrics[key])], metrics[key],
                            label=key)
            ax.set_xlabel('step')
            ax.legend()
            fig.savefig(args.out, bbox_inches='tight')
            print(f'wrote {args.out}')


if __name__ == '__main__':
    main()
