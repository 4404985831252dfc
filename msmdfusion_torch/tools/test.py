"""Evaluation / inference CLI.

Counterpart of the JAX package's ``tools/test.py`` (reference
tools/test.py:101-219): the config's test dataset -> the loader -> the
detector and ``get_bboxes`` -> masked detections -> ``--out`` pickle,
``--format-only`` submission or ``--eval`` metrics (the dataset's
``evaluate``: the native mAP/NDS).

    python -m msmdfusion_torch.tools.test CONFIG [CHECKPOINT] \\
        [--out results.pkl] [--eval bbox | --format-only] \\
        [--max-samples N] [--cfg-options key=value ...] [--device cuda]

The detector runs on ``--device`` (default ``cuda``; without a card the
run stops unless ``--device cpu`` is given). ``--launcher`` takes only
``none``. The submission JSON is written as ``results_nusc.json`` in the
working directory, as the JAX tool writes it.
"""
from __future__ import annotations

import argparse
import pickle
import time
from typing import Any, Dict, List, Optional

from ..apis.inference import init_detector, make_batch_infer
from ..config import load_config, parse_cli_overrides
from ..datasets.loader import DataLoader
from ..models.builder import resolve_device
from ..registry import DATASETS
from ..utils import overflow
from . import check_launcher


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description='Test a detector')
    p.add_argument('config')
    p.add_argument('checkpoint', nargs='?', default=None)
    p.add_argument('--out', default=None, help='pickle output path')
    p.add_argument('--eval', nargs='*', default=None)
    p.add_argument('--format-only', action='store_true')
    p.add_argument('--max-samples', type=int, default=None)
    p.add_argument('--cfg-options', nargs='+', default=[])
    p.add_argument('--launcher', default='none',
                   help='only none: distributed runs are not ported')
    p.add_argument('--device', default='cuda',
                   help='the detector\'s device (cuda or cpu)')
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Run the CLI; returns dict(results, model, dataset, seconds, fps,
    frame_s: the seconds from the loader's start at which each frame's
    detections were on the host, overflow, and metrics or submission
    where asked) for callers that run it in-process."""
    import msmdfusion_torch.datasets  # noqa: F401  (registers the pipeline)
    args = parse_args(argv)
    check_launcher(args.launcher)
    device = resolve_device(args.device)
    cfg = load_config(args.config, parse_cli_overrides(args.cfg_options))
    dataset = DATASETS.build(dict(cfg.data.test))
    if not args.checkpoint:
        print('WARNING: no checkpoint; weights drawn from seed 0')
    model, _ = init_detector(cfg, args.checkpoint, device=device)
    infer = make_batch_infer(model, cfg.model.type)

    results, frame_s = [], []
    with overflow.capture() as cap, DataLoader(
            dataset, 1, shuffle=False, drop_last=False,
            num_workers=cfg.data.get('workers_per_gpu', 4),
            device=device) as loader:
        t0 = time.perf_counter()
        for i, batch in enumerate(loader):
            if args.max_samples and i >= args.max_samples:
                break
            results.extend(infer(batch))
            frame_s.append(time.perf_counter() - t0)
            if (i + 1) % 50 == 0:
                print(f'{i + 1} samples, '
                      f'{(i + 1) / (time.perf_counter() - t0):.2f} fps',
                      flush=True)
        seconds = time.perf_counter() - t0
    counts = cap.counters()
    total = sum(counts.values())
    summary = dict(results=results, model=model, dataset=dataset,
                   seconds=seconds, fps=len(results) / seconds,
                   frame_s=frame_s, overflow=counts)
    print(f'{len(results)} samples in {seconds:.3f} s, '
          f'{summary["fps"]:.3f} frames/s; overflow_total {total}'
          + (f' {dict((k, v) for k, v in counts.items() if v)}'
             if total else ''), flush=True)

    if args.out:
        with open(args.out, 'wb') as f:
            pickle.dump(results, f)
    if args.format_only:
        summary['submission'] = dataset.format_results(results)
        print(f'submission written to {summary["submission"]}')
    elif args.eval is not None:
        summary['metrics'] = dataset.evaluate(results)
        print(summary['metrics'])
    return summary


if __name__ == '__main__':
    main()
