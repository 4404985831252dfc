"""The port's CLIs over 2 gloo ranks on the CPU (``--device cpu``).

- The eval CLI under torchrun (``msmdfusion_torch/tools/dist_test.sh``,
  ``--launcher pytorch``), on TransFusion-L's dataset and on the tiny
  flagship's of ``tests/test_torch_tools.py``: the merged ``--out``
  detections, written by rank 0, equal the single-process CLI's sample
  for sample, bit for bit (each rank's frames run alone, as one process
  runs them: nothing of a rank's evaluation depends on another's).
- The train CLI over 2 ranks on the tiny TransFusion-L dataset of
  ``tests/test_train_cli.py`` (``--launcher manual``, each rank its half of
  each global batch of 4): one step, one checkpoint, written once (by
  rank 0: one checkpoint, one ``train.log``, one JSON log with its train
  and rank-sharded val records); both ranks end with the checkpoint's
  tensors; their batches are the two halves of the epoch's global batch.
"""
import json
import os
import pickle
import subprocess

import numpy as np
import torch

from msmdfusion_torch.config import load_config
from msmdfusion_torch.datasets.loader import DataLoader
from msmdfusion_torch.registry import DATASETS
from msmdfusion_torch.tools import test as test_cli
from tests.test_flagship_pipeline import multimodal_dataset  # noqa: F401
from tests.test_torch_bf16_train import one_thread  # noqa: F401
from tests.test_torch_tools import config  # noqa: F401
from tests.test_train_cli import synthetic_dataset  # noqa: F401
from tests.torch_ranks import free_port, run_ranks, train_cli_rank

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ['--device', 'cpu', '--cfg-options', 'data.workers_per_gpu=0']


def test_eval_cli_over_two_ranks(config, tmp_path):  # noqa: F811
    path, _ = config
    one = test_cli.main([path, '--out', str(tmp_path / 'one.pkl'), *CPU])
    env = dict(os.environ, PORT=str(free_port()), OMP_NUM_THREADS='1')
    proc = subprocess.run(
        ['bash', os.path.join(REPO, 'msmdfusion_torch', 'tools',
                              'dist_test.sh'), path, '', '2', '--out',
         str(tmp_path / 'two.pkl'), *CPU],
        capture_output=True, text=True, env=env, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(tmp_path / 'two.pkl', 'rb') as f:
        two = pickle.load(f)
    assert len(two) == len(one['results']) == len(one['dataset'])
    for got, want in zip(two, one['results']):
        for key in ('bboxes', 'scores', 'labels'):
            assert np.array_equal(got[key], want[key]), key


def test_train_cli_over_two_ranks(synthetic_dataset, tmp_path,  # noqa: F811
                                  monkeypatch):
    _, path = synthetic_dataset
    work = str(tmp_path / 'work')
    argv = [path, '--work-dir', work, '--max-steps', '1', *CPU]
    monkeypatch.chdir(tmp_path)     # the val submission goes to the cwd
    ranks = run_ranks(train_cli_rank, 2, argv, join=False)
    ckpt = os.path.join(work, 'ckpt_1')
    files = sorted(os.listdir(work))
    logs = [f for f in files if f.endswith('.log.json')]
    assert len(logs) == 1 and sorted(set(files) - set(logs)) == [
        'ckpt_1', 'train.log'], files
    state = torch.load(ckpt, map_location='cpu', weights_only=True)
    assert state['step'] == 1
    for rank in ranks:
        assert rank['checkpoint'] == ckpt and rank['step'] == 1
        for key, value in state['state_dict'].items():
            np.testing.assert_array_equal(rank['state'][key], value.numpy(),
                                          key)
    cfg = load_config(path)
    order = DataLoader(DATASETS.build(dict(cfg.data.train)),
                       cfg.data.samples_per_gpu * 2, seed=0)
    first = order.index_batches()[0].tolist()
    assert [r['batches'][0] for r in ranks] == [first[:2], first[2:]]
    with open(os.path.join(work, logs[0])) as f:
        records = [json.loads(line) for line in f]
    assert [r['mode'] for r in records] == ['train', 'val']
    assert np.isfinite(records[0]['total_loss'])
    assert {'mAP', 'NDS'} <= set(records[1])
