"""Evaluation / inference CLI.

Counterpart of the JAX package's ``tools/test.py`` (reference
tools/test.py:101-219): the config's test dataset -> the loader -> the
detector and ``get_bboxes`` -> masked detections -> ``--out`` pickle,
``--format-only`` submission or ``--eval`` metrics (the dataset's
``evaluate``: the native mAP/NDS).

    python -m msmdfusion_torch.tools.test CONFIG [CHECKPOINT] \\
        [--out results.pkl] [--eval bbox | --format-only] \\
        [--max-samples N] [--cfg-options key=value ...] [--device cuda] \
        [--launcher none | pytorch | manual] [--backend nccl | gloo]

The detector runs on ``--device`` (default ``cuda``; without a card the
run stops unless ``--device cpu`` is given), with full fp32 products
(``full_fp32``: TF32 off). ``--launcher pytorch`` (under
torchrun: ``dist_test.sh``) or ``manual`` evaluates rank-sharded, as the
JAX tool does (``tools/test.py:53-94``): rank r runs the samples
``shard_indices(n, r, world)`` (``--max-samples`` counts each rank's), the
ranks' detections are gathered (``collect_results``) and put back in
dataset order (``merge_sharded_results``), and only rank 0 writes
``--out``, formats or evaluates. The submission JSON is written as
``results_nusc.json`` in the working directory, as the JAX tool writes it.
"""
from __future__ import annotations

import argparse
import pickle
import time
from typing import Any, Dict, List, Optional

from ..apis.inference import init_detector, make_batch_infer
from ..config import load_config, parse_cli_overrides
from ..datasets.loader import DataLoader
from ..parallel.distributed import (collect_results, dist_scope, get_rank,
                                    get_world_size, merge_sharded_results,
                                    shard_indices)
from ..registry import DATASETS
from ..utils import overflow
from . import check_launcher, full_fp32


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
                   help='none, pytorch (torchrun) or manual (MSMD_* '
                        'variables): rank-sharded evaluation')
    p.add_argument('--backend', default=None, choices=('nccl', 'gloo'),
                   help='the process group\'s (default: nccl on the card, '
                        'gloo on the CPU; gloo on the card for ranks that '
                        'share one card, which nccl refuses)')
    p.add_argument('--device', default='cuda',
                   help='the detector\'s device (cuda: each rank\'s card; '
                        'cuda:N; cpu)')
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Run the CLI; returns dict(results: every rank's detections in
    dataset order, model, dataset, seconds, fps and frame_s: this rank's
    frames, the seconds from the loader's start at which each frame's
    detections were on the host, overflow: summed over the ranks, and on
    rank 0 metrics or submission where asked) for callers that run it
    in-process."""
    import msmdfusion_torch.datasets  # noqa: F401  (registers the pipeline)
    args = parse_args(argv)
    check_launcher(args.launcher)
    full_fp32()
    with dist_scope(args.launcher, args.device,
                    args.backend) as device:
        return _test(args, device)


def _test(args, device) -> Dict[str, Any]:
    rank, world = get_rank(), get_world_size()
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
            device=device,
            indices=shard_indices(len(dataset), rank, world)) as loader:
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
    counts = cap.global_counters()
    total = sum(counts.values())
    summary = dict(results=results, model=model, dataset=dataset,
                   seconds=seconds, fps=len(results) / seconds,
                   frame_s=frame_s, overflow=counts)
    print(f'{len(results)} samples in {seconds:.3f} s, '
          f'{summary["fps"]:.3f} frames/s'
          + (f' on rank {rank} of {world}' if world > 1 else '')
          + f'; overflow_total {total}'
          + (f' {dict((k, v) for k, v in counts.items() if v)}'
             if total else ''), flush=True)
    if world > 1:
        # every rank ran its shard_indices: gathered, then in dataset order
        # (under --max-samples k the ranks' first k cover the first
        # k x world samples: the rest stay None and are left out)
        collected = collect_results(results)
        merged = merge_sharded_results(collected, len(dataset))
        summary['results'] = results = [r for r in merged if r is not None]
        if rank != 0:
            return summary

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
