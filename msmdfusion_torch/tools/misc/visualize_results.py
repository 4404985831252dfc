"""Visualize saved detection results (BEV PNG, OBJ and HTML per sample).

Counterpart of the JAX package's ``tools/misc/visualize_results.py``
(reference tools/misc/visualize_results.py:1-40): the ``--out`` pickle of
``python -m msmdfusion_torch.tools.test`` (per-sample dicts of numpy
``bboxes``, ``scores``, ``labels``), the config's test dataset for each
sample's points and ground truth, and ``core.visualizer.show_result``.

    python -m msmdfusion_torch.tools.misc.visualize_results CONFIG \\
        --result results.pkl --show-dir DIR [--max-samples 20] \\
        [--cfg-options key=value ...] [--device cuda]

It reads files and draws on the host; like every entry point of the port
it stops on a machine with no card unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import os
import pickle
from typing import List, Optional

import numpy as np

from ...config import load_config, parse_cli_overrides
from ...registry import DATASETS
from .. import add_device, device_of


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description='visualize results')
    p.add_argument('config')
    p.add_argument('--result', required=True, help='results .pkl')
    p.add_argument('--show-dir', required=True)
    p.add_argument('--max-samples', type=int, default=20)
    p.add_argument('--cfg-options', nargs='+', default=[])
    add_device(p, 'nothing (the tool draws on the host)')
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> List[str]:
    """Run the tool; returns the files written."""
    import msmdfusion_torch.datasets  # noqa: F401  (registers the pipeline)
    from ...core.visualizer import show_result
    args = parse_args(argv)
    device_of(args)
    assert args.result.endswith(('.pkl', '.pickle')), \
        'unsupported result format'
    cfg = load_config(args.config, parse_cli_overrides(args.cfg_options))
    dataset = DATASETS.build(dict(cfg.data.test))
    with open(args.result, 'rb') as f:
        results = pickle.load(f)
    os.makedirs(args.show_dir, exist_ok=True)
    written = []
    for i, det in enumerate(results[:args.max_samples]):
        info = dataset.get_data_info(i)
        pts_file = info.get('pts_filename')
        points = np.fromfile(pts_file, np.float32).reshape(-1, 5)[:, :3] \
            if pts_file and os.path.exists(pts_file) else np.zeros((0, 3))
        ann = dataset.get_ann_info(i) if hasattr(dataset, 'get_ann_info') \
            else {}
        written += show_result(points, ann.get('gt_bboxes_3d'),
                               np.asarray(det['bboxes']), args.show_dir,
                               f'sample_{i}')
    print(f'wrote {min(len(results), args.max_samples)} visualizations '
          f'to {args.show_dir}')
    return written


if __name__ == '__main__':
    main()
