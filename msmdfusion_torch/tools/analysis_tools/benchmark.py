"""Inference speed CLI: frames/s of a config on synthetic points.

Counterpart of the JAX package's ``tools/analysis_tools/benchmark.py``
(reference tools/analysis_tools/benchmark.py: warm-up, then synchronised
timing): the same arguments, the same uniform points over the config's
range from ``np.random.RandomState(0)`` (x, y, z uniform in range, two
more features uniform in [0, 1)), weights from seed 0 (or the
checkpoint's), ``--warmup`` untimed frames, then ``--samples`` frames of
the detector and its ``get_bboxes`` each timed by the host clock between
two device synchronisations. It prints the rows dropped at every capacity
site (``overflow_total``), then the JAX tool's three lines.

    python -m msmdfusion_torch.tools.analysis_tools.benchmark CONFIG \\
        [CHECKPOINT] [--samples 50] [--warmup 5] [--num-points 200000] \\
        [--device cuda]

The JAX tool runs a model from points alone (``model.apply(variables,
points, mask)``), so a config whose detector needs more cannot run there:
``MSMDFusionDetector`` takes the camera images and the foreground
artifacts (JAX ``MSMDFusionDetector.__call__(points, points_mask, img,
fg)``). The port refuses exactly those configs, with that reason;
TransFusion-LC runs as TransFusion-L, as the JAX tool runs it without
images.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import add_device, device_of, full_fp32

# detectors the JAX tool cannot run from points alone: what each needs
NEEDS_MORE = {'MSMDFusionDetector': 'camera images and the foreground '
                                    'artifacts (img, fg)'}


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser()
    p.add_argument('config')
    p.add_argument('checkpoint', nargs='?', default=None)
    p.add_argument('--samples', type=int, default=50)
    p.add_argument('--warmup', type=int, default=5)
    p.add_argument('--num-points', type=int, default=200000)
    add_device(p, 'the detector')
    return p.parse_args(argv)


def uniform_points(pcr, n: int) -> np.ndarray:
    """[1, n, 5] float32: the JAX tool's points (``benchmark.py:42-50``)."""
    rng = np.random.RandomState(0)
    return np.concatenate([
        rng.uniform(pcr[0], pcr[3], (1, n, 1)),
        rng.uniform(pcr[1], pcr[4], (1, n, 1)),
        rng.uniform(pcr[2], pcr[5], (1, n, 1)),
        rng.uniform(0, 1, (1, n, 2))], axis=-1).astype(np.float32)


def main(argv: Optional[List[str]] = None) -> Dict:
    """Run the CLI; returns dict(times: seconds a frame, overflow: rows
    dropped by site over the warm-up and timed frames)."""
    from ...apis.inference import init_detector
    from ...config import load_config
    from ...utils import overflow
    args = parse_args(argv)
    device = device_of(args)
    full_fp32()
    cfg = load_config(args.config)
    if cfg.model.type in NEEDS_MORE:
        raise SystemExit(
            f'{args.config}: {cfg.model.type} needs '
            f'{NEEDS_MORE[cfg.model.type]}, which this tool does not '
            'make (nor does the JAX package\'s: it passes points alone)')
    model, _ = init_detector(cfg, args.checkpoint, device=device)
    pcr = cfg.model.pts_voxel_layer.point_cloud_range
    pts = torch.from_numpy(uniform_points(pcr, args.num_points)).to(device)
    mask = torch.ones((1, args.num_points), dtype=torch.bool, device=device)

    def sync():
        if device.type == 'cuda':
            torch.cuda.synchronize(device)

    def infer():
        with torch.inference_mode():
            return model.get_bboxes(model(pts, mask))

    model.eval()
    times = []
    with overflow.capture() as cap:
        for _ in range(args.warmup):
            infer()
        sync()
        for _ in range(args.samples):
            t0 = time.perf_counter()
            infer()
            sync()
            times.append(time.perf_counter() - t0)
    counts = cap.counters()
    print(f'overflow_total {sum(counts.values())}'
          + (f' {dict((k, v) for k, v in counts.items() if v)}'
             if sum(counts.values()) else ''))
    arr = np.asarray(times)
    print(f'fps (median): {1.0 / np.median(arr):.2f}')
    print(f'fps (best):   {1.0 / arr.min():.2f}')
    print(f'latency ms: min {arr.min()*1e3:.1f} '
          f'median {np.median(arr)*1e3:.1f} max {arr.max()*1e3:.1f}')
    return dict(times=times, overflow=counts)


if __name__ == '__main__':
    main()
