"""The port's eval and train CLIs, in-process on the CPU.

``python -m msmdfusion_torch.tools.test`` and ``...tools.train`` with
``--device cpu`` on two tiny configs: TransFusion-L (``CONFIG_TEMPLATE`` of
``tests/test_train_cli.py``) and the flagship (``multimodal_dataset`` of
``tests/test_flagship_pipeline.py``, its grids made to match its range, a
test pipeline and an ``evaluation`` added). Eval with ``--out``, ``--eval``
and ``--format-only``, its detections bit-equal to a direct model call on
the same batch; three train steps with a checkpoint, the train and val
records, a resume; and the refusals: no card without ``--device cpu``, a
``--launcher`` other than ``none``, a JPEG without PIL.
"""
import json
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from msmdfusion_torch.apis.inference import (batch_model_inputs,
                                             inference_detector,
                                             unpack_detections)
from msmdfusion_torch.config import load_config
from msmdfusion_torch.datasets.loader import DataLoader
from msmdfusion_torch.registry import DATASETS
from msmdfusion_torch.tools import test as test_cli
from msmdfusion_torch.tools import train as train_cli
from msmdfusion_torch.utils.checkpoint import load_checkpoint
from tests.test_flagship_pipeline import multimodal_dataset  # noqa: F401
from tests.test_torch_bf16_train import one_thread  # noqa: F401
from tests.test_train_cli import synthetic_dataset  # noqa: F401

# the flagship fixture's config: grids that match its 9.6 m range at 0.3 m
# voxels, the flagship config's test pipeline, val/test sets, the EvalHook
FLAGSHIP_EXTRA = '''
model['spatial_shapes'] = [[41, 32, 32], [21, 16, 16], [11, 8, 8], [5, 4, 4]]
model['pts_middle_encoder']['sparse_shape'] = [41, 32, 32]
model['train_cfg']['pts']['grid_size'] = [32, 32, 40]
model['test_cfg']['pts']['grid_size'] = [32, 32, 40]
test_pipeline = [
    dict(type='LoadPointsFromFile', coord_type='LIDAR', load_dim=5,
         use_dim=[0, 1, 2, 3, 4]),
    dict(type='LoadPointsFromMultiSweeps', sweeps_num=2,
         use_dim=[0, 1, 2, 3, 4]),
    dict(type='LoadMultiViewImageFromFiles'),
    dict(type='LoadForeground2D', dataset='NuScenesDataset'),
    dict(type='LoadForeground2DFromMultiSweeps', dataset='NuScenesDataset',
         sweeps_num=2),
    dict(type='GlobalRotTransFilterForeground2D',
         point_cloud_range=point_cloud_range),
    dict(type='MyResize', img_scale=img_scale, keep_ratio=True),
    dict(type='MyNormalize', **img_norm_cfg),
    dict(type='MyPad', size_divisor=32),
    dict(type='ImgScaleCropFlipForeground2D'),
    dict(type='PadPoints', max_points=512),
    dict(type='PadForeground2D', max_points=64, max_real_points=32),
    dict(type='FormatBundle3D', class_names=class_names, with_label=False),
]
data['val'] = dict(type='NuScenesDataset', data_root='ROOT',
                   ann_file='ROOT/infos.pkl', pipeline=test_pipeline,
                   classes=class_names,
                   modality=dict(use_lidar=True, use_camera=True),
                   test_mode=True, box_type_3d='LiDAR')
evaluation = dict(interval=1, max_samples=2)
'''
CPU = ['--device', 'cpu']
# the pipeline in this process: the loader's worker processes are held in
# tests/test_torch_loader.py
NO_WORKERS = ['data.workers_per_gpu=0']


@pytest.fixture(params=['TransFusion-L', 'MSMDFusion'])
def config(request, tmp_path, monkeypatch, one_thread):  # noqa: F811
    """(config path, root) of a tiny model's dataset; cwd in ``tmp_path``
    (the submission is written to the working directory)."""
    if request.param == 'TransFusion-L':
        root, path = request.getfixturevalue('synthetic_dataset')
    else:
        root, path = request.getfixturevalue('multimodal_dataset')
        with open(path, 'a') as f:
            f.write(FLAGSHIP_EXTRA.replace('ROOT', str(root)))
    with open(path, 'a') as f:
        f.write("\ndata['test'] = dict(data['val'])\n")
    monkeypatch.chdir(tmp_path)
    return path, root


def _direct(model, cfg, batch):
    """The detections of ``model.get_bboxes(model(...))`` on ``batch``."""
    with torch.no_grad():
        inputs = batch_model_inputs(cfg.model.type, batch, 'cpu')
        return unpack_detections(model.get_bboxes(model(*inputs)))


def test_eval_cli(config, tmp_path):
    path, _ = config
    out = str(tmp_path / 'results.pkl')
    run = test_cli.main([path, '--out', out, '--eval', 'bbox', *CPU,
                         '--cfg-options', *NO_WORKERS])
    n = len(run['dataset'])
    with open(out, 'rb') as f:
        results = pickle.load(f)
    assert len(results) == len(run['results']) == n
    assert {'mAP', 'NDS'} <= set(run['metrics'])
    cfg = load_config(path)
    with DataLoader(run['dataset'], 1, shuffle=False, drop_last=False,
                    num_workers=0) as loader:
        for det, batch in zip(results, loader):
            want, = _direct(run['model'], cfg, batch)
            for key in ('bboxes', 'scores', 'labels'):
                assert np.array_equal(det[key], want[key]), key
            assert np.isfinite(det['bboxes']).all()

    # inference_detector on sample 0's files: the flagship with its views
    # (no sweeps there: LoadPointsFromMultiSweeps pads with the keyframe),
    # TransFusion-L exactly the CLI's detections
    info = run['dataset'].get_data_info(0)
    views = {} if cfg.model.type != 'MSMDFusionDetector' else dict(
        img_paths=info['img_filename'], lidar2img=info['lidar2img'])
    det = inference_detector(run['model'], cfg, info['pts_filename'],
                             **views)
    assert det['boxes_3d'].shape[1] == 9 and np.isfinite(
        det['boxes_3d']).all()
    if not views:
        assert np.array_equal(det['boxes_3d'], results[0]['bboxes'])
        assert np.array_equal(det['scores_3d'], results[0]['scores'])

    run = test_cli.main([path, '--format-only', '--max-samples', '1', *CPU,
                         '--cfg-options', *NO_WORKERS])
    assert len(run['results']) == 1 and 'metrics' not in run
    with open(run['submission']) as f:
        sub = json.load(f)
    assert set(sub) == {'meta', 'results'} and len(sub['results']) == 1
    for annos in sub['results'].values():
        for a in annos:
            assert set(a) == {'sample_token', 'translation', 'size',
                              'rotation', 'velocity', 'detection_name',
                              'detection_score', 'attribute_name'}


def _records(work_dir):
    logs = [f for f in os.listdir(work_dir) if f.endswith('.log.json')]
    records = []
    for name in logs:
        with open(os.path.join(work_dir, name)) as f:
            records += [json.loads(line) for line in f]
    return records


def test_train_cli(config, tmp_path):
    path, _ = config
    work = str(tmp_path / 'work')
    args = [path, '--work-dir', work, *CPU, '--cfg-options', *NO_WORKERS,
            'total_epochs=2']
    run = train_cli.main(args + ['--max-steps', '3'])
    assert run['step'] == 3 and len(run['batches']) == 3
    assert run['checkpoint'] == os.path.join(work, 'ckpt_3')
    state = load_checkpoint(run['checkpoint'])
    assert state['step'] == 3 and state['optimizer']['count'] == 3
    for k, v in run['model'].state_dict().items():
        assert torch.equal(state['state_dict'][k], v), k
    records = _records(work)
    train = [r for r in records if r['mode'] == 'train']
    assert len(train) == 3 and {'total_loss', 'grad_norm', 'lr'} <= set(
        train[0]) and all(np.isfinite(r['total_loss']) for r in train)
    val = [r for r in records if r['mode'] == 'val']
    assert val and {'mAP', 'NDS'} <= set(val[0]) and any(
        k.startswith('overflow/') for k in val[0])
    with open(os.path.join(work, 'train.log')) as f:
        assert 'val: ' in f.read()

    # auto-resume from the work dir at step 3, in the epoch it falls in,
    # that epoch's batch order from its first batch
    again = train_cli.main(args + ['--max-steps', '4', '--no-validate'])
    assert (again['start_step'], again['step']) == (3, 4)
    cfg = load_config(path)
    order = DataLoader(DATASETS.build(dict(cfg.data.train)),
                       cfg.data.samples_per_gpu, seed=0)
    order.set_epoch(3 // len(order))
    assert again['batches'] == [order.index_batches()[0].tolist()]
    assert os.path.exists(os.path.join(work, 'ckpt_4'))


def test_refusals(synthetic_dataset, tmp_path, monkeypatch):  # noqa: F811
    """No card and no --device cpu; a launcher other than none; a JPEG
    view with no PIL. None of them runs on."""
    _, path = synthetic_dataset
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for cli in (test_cli, train_cli):
        with pytest.raises(RuntimeError, match='torch.cuda.is_available'):
            cli.main([path, '--work-dir', str(tmp_path)] if cli is train_cli
                     else [path])
        with pytest.raises(NotImplementedError, match='DDP over NCCL'):
            cli.main([path, '--launcher', 'pytorch', *CPU])
    from PIL import Image
    from msmdfusion_torch.datasets.pipelines.loading import \
        LoadMultiViewImageFromFiles
    jpg = str(tmp_path / 'CAM_FRONT.jpg')
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(jpg)
    monkeypatch.setitem(sys.modules, 'PIL', None)
    with pytest.raises(ImportError, match='CAM_FRONT.jpg'):
        LoadMultiViewImageFromFiles()(dict(img_filename=[jpg]))
