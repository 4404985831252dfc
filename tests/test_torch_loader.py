"""The port's loader, checkpoints and logs against the JAX package's.

The per-epoch batch order against ``DataLoader._index_batches``,
``collate`` against JAX's, batches that do not depend on the number of
worker processes (and the pipeline's overflow counts carried back from
them), checkpoint round trips (the port's files, a reference-style
``{'state_dict': ...}`` file without the GMA dummy embeddings,
``latest_checkpoint``), and the JSON and TensorBoard logs against the JAX
writers' records.
"""
import json
import warnings

import numpy as np
import pytest
import torch
from torch import nn

import msmdfusion_torch.datasets  # noqa: F401
from msmdfusion_torch.apis.train import build_lr_schedule, build_optimizer
from msmdfusion_torch.config import load_config
from msmdfusion_torch.datasets.loader import DataLoader, collate
from msmdfusion_torch.registry import DATASETS
from msmdfusion_torch.utils import overflow
from msmdfusion_torch.utils.checkpoint import (latest_checkpoint,
                                               load_checkpoint,
                                               save_checkpoint)
from msmdfusion_tpu.datasets.loader import DataLoader as JaxDataLoader
from msmdfusion_tpu.datasets.loader import collate as jax_collate
from tests.test_flagship_pipeline import multimodal_dataset  # noqa: F401
from tests.test_torch_datasets import assert_same


@pytest.mark.parametrize('drop_last', [True, False])
def test_epoch_order_is_jax_loaders(drop_last):
    data = list(range(11))
    port = DataLoader(data, 3, seed=5, drop_last=drop_last)
    want = JaxDataLoader(data, 3, seed=5, drop_last=drop_last)
    assert len(port) == len(want)
    for epoch in (0, 1, 2, 0):
        port.set_epoch(epoch)
        want.set_epoch(epoch)
        got = port.index_batches()
        assert [b.tolist() for b in got] == \
            [b.tolist() for b in want._index_batches()]
    unshuffled = DataLoader(data, 4, shuffle=False, drop_last=False)
    assert [b.tolist() for b in unshuffled.index_batches()] == \
        [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10]]


def _train_set(cfg_path):
    return DATASETS.build(dict(load_config(cfg_path).data.train))


def test_collate_is_jax(multimodal_dataset):  # noqa: F811
    ds = _train_set(multimodal_dataset[1])
    samples = [ds.sample(i, np.random.RandomState(i)) for i in range(3)]
    got = collate(samples)
    want = jax_collate(samples)

    def numpy(x):
        if isinstance(x, torch.Tensor):
            return x.numpy()
        if isinstance(x, dict):
            return {k: numpy(v) for k, v in x.items()}
        return x
    assert_same({k: numpy(v) for k, v in got.items()}, want)
    assert collate([None, None]) is None


def test_batches_do_not_depend_on_workers(multimodal_dataset):  # noqa: F811
    """Two worker processes and none give the same batches of the train
    pipeline (every sample drawn from its (seed, epoch, index)
    generator) and the same overflow counts, recorded in the caller's
    scope (PadPoints drops the points past 512)."""
    ds = _train_set(multimodal_dataset[1])
    runs = []
    for workers in (0, 2):
        with overflow.capture() as cap, DataLoader(
                ds, 2, seed=3, num_workers=workers) as loader:
            loader.set_epoch(1)
            batches = list(loader)
        runs.append((batches, cap.counters()))
    (got, got_counts), (want, want_counts) = runs
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for key in ('points', 'points_mask', 'img', 'gt_bboxes_3d',
                    'gt_labels_3d', 'gt_valid'):
            assert torch.equal(g[key], w[key]), key
        for key in g['foreground']:
            assert torch.equal(g['foreground'][key], w['foreground'][key])
        assert [m['sample_idx'] for m in g['metas']] == \
            [m['sample_idx'] for m in w['metas']]
    assert got_counts == want_counts and got_counts['pipeline.points_cap']
    # each sample drew from its (seed, epoch, index) generator
    first = collate([ds.sample(int(i), np.random.RandomState([3, 1, int(i)]))
                     for i in _order(ds, 1)[0]])
    assert torch.equal(first['points'], got[0]['points'])


def _order(ds, epoch):
    loader = DataLoader(ds, 2, seed=3, num_workers=0)
    loader.set_epoch(epoch)
    return loader.index_batches()


class Tiny(nn.Module):
    """A linear layer, a batch norm and a GMA-style dummy embedding."""

    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(4, 3)
        self.norm = nn.BatchNorm1d(3)
        self.dummy_embedding_0 = nn.Parameter(torch.rand(3))

    def forward(self, x):
        return self.norm(self.fc(x)) + self.dummy_embedding_0


def _stepped(seed):
    """A Tiny model and its optimizer after two steps."""
    torch.manual_seed(seed)
    model = Tiny()
    opt = build_optimizer(model, dict(lr=0.1, weight_decay=0.01),
                          dict(grad_clip=dict(max_norm=1.0)),
                          build_lr_schedule(dict(policy='step'), 0.1, 10, 5))
    for _ in range(2):
        model.zero_grad()
        model(torch.randn(8, 4)).square().sum().backward()
        opt.step()
    return model, opt


def test_checkpoint_round_trip(tmp_path):
    model, opt = _stepped(0)
    path = save_checkpoint(str(tmp_path), 2, model, opt,
                           meta={'epoch': 0, 'config': 'cfg.py'})
    save_checkpoint(str(tmp_path), 10, model)
    assert path == str(tmp_path / 'ckpt_2')
    assert latest_checkpoint(str(tmp_path)) == str(tmp_path / 'ckpt_10')
    assert latest_checkpoint(str(tmp_path / 'none')) is None

    fresh, fresh_opt = _stepped(1)
    state = load_checkpoint(path, fresh)
    fresh_opt.load_state_dict(state['optimizer'])
    assert state['step'] == 2 and state['meta'] == {'epoch': 0,
                                                    'config': 'cfg.py'}
    for (k, v), w in zip(model.state_dict().items(),
                         fresh.state_dict().values()):
        assert torch.equal(v, w), k
    assert fresh_opt.count == opt.count == 2
    for p, q in zip(model.parameters(), fresh.parameters()):
        for key in ('mu', 'nu'):
            assert torch.equal(opt.state[p][key], fresh_opt.state[q][key])


def test_reference_checkpoint_keeps_dummy_embeddings(tmp_path):
    """A reference mmdet3d-style file: its state_dict under the reference
    names, no GMA dummy embedding (listed in a warning, kept), and the
    reference's num_batches_tracked."""
    model, _ = _stepped(0)
    ref = {k: v + 1 for k, v in model.state_dict().items()
           if 'dummy_embedding' not in k}
    torch.save({'state_dict': ref, 'meta': {'epoch': 6}},
               str(tmp_path / 'ref.pth'))
    target, _ = _stepped(1)
    kept = target.dummy_embedding_0.detach().clone()
    with pytest.warns(UserWarning, match='dummy_embedding_0'):
        load_checkpoint(str(tmp_path / 'ref.pth'), target)
    assert torch.equal(target.dummy_embedding_0, kept)
    for k, v in ref.items():
        assert torch.equal(target.state_dict()[k], v), k
    # any other key missing raises
    del ref['fc.weight']
    torch.save({'state_dict': ref}, str(tmp_path / 'bad.pth'))
    with warnings.catch_warnings(), pytest.raises(KeyError,
                                                  match='fc.weight'):
        warnings.simplefilter('ignore')
        load_checkpoint(str(tmp_path / 'bad.pth'), target)


def test_json_and_tensorboard_logs_are_jax_writers(tmp_path):
    from msmdfusion_torch.utils.log_hooks import JsonLogWriter
    from msmdfusion_torch.utils.tb_writer import (TensorboardEventWriter,
                                                  read_events)
    from msmdfusion_tpu.utils.log_hooks import JsonLogWriter as JaxJson
    from msmdfusion_tpu.utils.tb_writer import \
        TensorboardEventWriter as JaxTb
    from msmdfusion_tpu.utils.tb_writer import read_events as jax_read
    scalars = dict(total_loss=torch.tensor(1.25), grad_norm=np.float32(3.5),
                   loss_heatmap=0.75)
    records = []
    for i, (json_w, tb_w) in enumerate(((JsonLogWriter, TensorboardEventWriter),
                                        (JaxJson, JaxTb))):
        w = json_w(str(tmp_path / f'j{i}'), 'x.log.json')
        w.write('train', 0, 3, scalars, lr=1e-4, samples_per_s=2.5)
        w.write('val', 0, 3, {'mAP': 0.5, 'overflow/a': 0.0})
        tb = tb_w(str(tmp_path / f't{i}'))
        tb.write('train', 0, 3, scalars, lr=1e-4)
        tb.write('val', 0, 3, {'mAP': 0.5})
        with open(w.path) as f:
            lines = [json.loads(line) for line in f]
        records.append((lines, read_events(tb.path), jax_read(tb.path)))
    (got_json, got_tb, got_tb_jax), (want_json, want_tb, _) = records
    assert got_json == want_json
    assert set(got_json[0]) == {'mode', 'epoch', 'iter', 'total_loss',
                                'grad_norm', 'loss_heatmap', 'lr',
                                'samples_per_s'}
    assert got_tb == got_tb_jax == want_tb
    assert want_tb[1][1] == {'train/total_loss': 1.25, 'train/grad_norm': 3.5,
                             'train/loss_heatmap': 0.75,
                             'train/lr': np.float32(1e-4)}
