"""The indoor data path, port vs the JAX package, on the CPU (numpy; no
JAX compile).

- The indoor transforms (``IndoorPointSample`` with and without
  replacement, ``PointSegClassMapping``, ``NormalizePointsColor``,
  ``BackgroundPointsFilter``, ``VoxelBasedPointSampler``) and
  ``GlobalRotScaleTrans(shift_height=True)`` under a seeded
  ``RandomState`` against the JAX transforms under ``np.random.seed``:
  equal outputs.
- The restored branches: ``LoadPointsFromFile(shift_height=True)`` (.bin
  and .npy) and ``LoadAnnotations3D(with_mask_3d, with_seg_3d)``.
- ``ScanNetDataset`` and ``SUNRGBDDataset`` on files written by
  ``chip_smoke.write_scannet``/``write_sunrgbd``: infos, annotations and
  the configs' train and test pipelines (seeded) equal to the JAX
  readers'.
- ``indoor_eval`` against the JAX one on the same predictions (the JAX
  module's 3-D IoU set to the port's, so nothing compiles; the IoU
  itself is held in ``tests/test_torch_targets.py``).
- The eval and train CLIs in-process (``--device cpu``) on a tiny
  ScanNet-layout set with a tiny VoteNet: 2 train steps, then the eval
  CLI's indoor metrics and sample 0's detections equal to a direct
  call.
"""
import copy
import os

import numpy as np
import pytest
import torch

import chip_smoke as smoke
import msmdfusion_torch.datasets  # noqa: F401
import msmdfusion_tpu.datasets  # noqa: F401
from msmdfusion_torch.apis.inference import (batch_model_inputs,
                                             unpack_detections)
from msmdfusion_torch.config import load_config
from msmdfusion_torch.core.evaluation import indoor_eval as port_eval
from msmdfusion_torch.datasets.loader import DataLoader
from msmdfusion_torch.registry import DATASETS, PIPELINES
from msmdfusion_torch.tools import test as test_cli
from msmdfusion_torch.tools import train as train_cli
from msmdfusion_torch.utils.synth_scene import indoor_room
from msmdfusion_tpu.core.evaluation import indoor_eval as jax_eval
from msmdfusion_tpu.registry import DATASETS as JAX_DATASETS
from msmdfusion_tpu.registry import PIPELINES as JAX_PIPELINES
from tests.test_torch_datasets import assert_same
from tests.torch_threads import one_thread  # noqa: F401

SCANNET = os.path.abspath('configs/votenet_scannet.py')
SUNRGBD = os.path.abspath('configs/votenet_sunrgbd.py')


def both(cfg):
    return PIPELINES.build(copy.deepcopy(cfg)), \
        JAX_PIPELINES.build(copy.deepcopy(cfg))


def run_both(cfg, results, seed):
    """The port's transform under RandomState(seed), the JAX one under
    np.random.seed(seed), each on its own copy of ``results``."""
    port, jax_t = both(cfg)
    a, b = copy.deepcopy(results), copy.deepcopy(results)
    got = port(a, np.random.RandomState(seed)) if getattr(
        port, 'draws', False) else port(a)
    np.random.seed(seed)
    return got, jax_t(b)


def room(seed=0, n=3000, yawed=False):
    cfg = load_config(SUNRGBD if yawed else SCANNET)
    ids = (cfg.train_pipeline[2]['valid_cat_ids'] if not yawed
           else tuple(range(10)))
    return indoor_room(np.random.RandomState(seed), n,
                       cfg.model.bbox_head['mean_sizes'], ids, yawed=yawed)


def with_masks(r):
    return dict(points=r['points'].copy(),
                pts_instance_mask=r['instance'].copy(),
                pts_semantic_mask=r['semantic'].copy())


@pytest.mark.parametrize('num_points', [2000, 5000])
def test_indoor_point_sample_matches_jax(num_points):
    """5000 of 3000 points: drawn with replacement."""
    got, want = run_both(dict(type='IndoorPointSample',
                              num_points=num_points), with_masks(room()), 3)
    assert_same(got, want)
    unique = len(np.unique(got['points'], axis=0))
    assert unique < num_points if num_points > 3000 else unique == 2000


def test_seg_mapping_and_colour_match_jax():
    r = with_masks(room(1))
    r['pts_semantic_mask'][:10] = 99              # past the table
    cfg = load_config(SCANNET).train_pipeline[2]
    got, want = run_both(dict(cfg), r, 0)
    assert_same(got, want)
    assert got['pts_semantic_mask'].max() == 18
    got, want = run_both(dict(type='NormalizePointsColor',
                              color_mean=[120.0, 110.0, 100.0]), r, 0)
    assert_same(got, want)


def test_background_points_filter_matches_jax():
    r = room(2, yawed=True)
    boxes = r['boxes'].copy()
    boxes[:, 2] -= boxes[:, 5] / 2
    results = dict(with_masks(r), gt_bboxes_3d=boxes)
    got, want = run_both(dict(type='BackgroundPointsFilter',
                              bbox_enlarge_range=(0.5, 2.0, 0.5)),
                         results, 0)
    assert_same(got, want)
    assert len(got['points']) < len(r['points'])


def test_voxel_based_point_sampler_matches_jax():
    r = with_masks(room(3))
    pts = r['points'][:, :4].copy()
    pts[:, 3] = (np.arange(len(pts)) % 2).astype(np.float32)   # sweep time
    r['points'] = pts
    cfg = dict(type='VoxelBasedPointSampler',
               cur_sweep_cfg=dict(voxel_size=[0.1, 0.1, 0.1],
                                  point_cloud_range=[0, 0, -0.5, 8, 8, 3],
                                  max_num_points=1, max_voxels=800),
               prev_sweep_cfg=dict(voxel_size=[0.2, 0.2, 0.2],
                                   point_cloud_range=[0, 0, -0.5, 8, 8, 3],
                                   max_num_points=1, max_voxels=400))
    got, want = run_both(cfg, r, 5)
    assert_same(got, want)
    assert got['points'].shape == (1200, 4)


@pytest.mark.parametrize('seed', [0, 1])
def test_rot_scale_trans_with_height_matches_jax(seed):
    r = room(4)
    pts = np.concatenate([r['points'][:, :3], r['points'][:, 2:3] + 0.1], 1)
    boxes = r['boxes'].copy()
    results = dict(points=pts, gt_bboxes_3d=boxes)
    cfg = dict(type='GlobalRotScaleTrans', rot_range=[-0.5, 0.5],
               scale_ratio_range=[0.85, 1.15], shift_height=True)
    got, want = run_both(cfg, results, seed)
    assert_same(got, want)
    scale = got['pcd_scale_factor']
    np.testing.assert_allclose(got['points'][:, 3], pts[:, 3] * scale,
                               rtol=1e-6)


@pytest.mark.parametrize('suffix', ['.bin', '.npy'])
def test_load_points_shift_height_and_masks_match_jax(tmp_path, suffix):
    r = room(5)
    path = str(tmp_path / f'p{suffix}')
    if suffix == '.npy':
        np.save(path, r['points'])
    else:
        r['points'].tofile(path)
    r['instance'].tofile(tmp_path / 'inst.bin')
    r['semantic'].tofile(tmp_path / 'sem.bin')
    cfg = dict(type='LoadPointsFromFile', coord_type='DEPTH',
               shift_height=True, load_dim=6, use_dim=[0, 1, 2])
    got, want = run_both(cfg, dict(pts_filename=path), 0)
    assert_same(got, want)
    assert got['points'].shape == (len(r['points']), 4)
    ann = dict(ann_info=dict(
        gt_bboxes_3d=r['boxes'], gt_labels_3d=r['labels'],
        pts_instance_mask_path=str(tmp_path / 'inst.bin'),
        pts_semantic_mask_path=str(tmp_path / 'sem.bin')))
    got, want = run_both(dict(type='LoadAnnotations3D', with_mask_3d=True,
                              with_seg_3d=True), ann, 0)
    assert_same(got, want)
    np.testing.assert_array_equal(got['pts_semantic_mask'], r['semantic'])


@pytest.fixture(scope='module')
def indoor_set(tmp_path_factory):
    root = tmp_path_factory.mktemp('indoor')
    rooms = [room(10 + i) for i in range(2)]
    paths = smoke.write_scannet(root / 'scannet', rooms,
                                dict(train=4, val=2))
    sun = room(12, yawed=True)
    k_mat, rt, _ = smoke.pinhole()
    sun_path = smoke.write_sunrgbd(root / 'sunrgbd', sun, np.zeros(
        (len(sun['labels']), 4), np.float32), k_mat, rt)
    return dict(root=root, rooms=rooms, sun=sun, sun_path=str(sun_path),
                **{k: str(v) for k, v in paths.items()})


def datasets(config, root, ann, split):
    cfg = dict(load_config(config).data[split], data_root=f'{root}/',
               ann_file=ann)
    return (DATASETS.build(copy.deepcopy(cfg)),
            JAX_DATASETS.build(copy.deepcopy(cfg)))


@pytest.mark.parametrize('split', ['train', 'val'])
def test_scannet_reader_and_pipeline_match_jax(indoor_set, split):
    port, jax_ds = datasets(SCANNET, indoor_set['root'] / 'scannet',
                            indoor_set[split], split)
    assert len(port) == len(jax_ds)
    for i in range(len(port)):
        assert_same(port.get_data_info(i), jax_ds.get_data_info(i))
        got, want = port.get_ann_info(i), jax_ds.get_ann_info(i)
        assert_same(got, want)
        r = indoor_set['rooms'][i % 2]
        np.testing.assert_array_equal(got['gt_labels_3d'], r['labels'])
        np.testing.assert_allclose(got['gt_bboxes_3d'][:, 2],
                                   r['boxes'][:, 2] - r['boxes'][:, 5] / 2)
        sample = port.sample(i, np.random.RandomState(20 + i))
        np.random.seed(20 + i)
        assert_same(sample, jax_ds[i])


def test_sunrgbd_reader_and_pipeline_match_jax(indoor_set):
    for split in ('train', 'test'):
        port, jax_ds = datasets(SUNRGBD, indoor_set['root'] / 'sunrgbd',
                                indoor_set['sun_path'], split)
        assert_same(port.get_ann_info(0), jax_ds.get_ann_info(0))
        assert port.get_ann_info(0)['gt_bboxes_3d'].shape[1] == 7
        sample = port.sample(0, np.random.RandomState(3))
        np.random.seed(3)
        assert_same(sample, jax_ds[0])
        assert sample['points'].shape == (20000, 4)


def predictions(rng, gts, classes):
    """Detections near each GT box (some exact, some off, some of another
    class) and false positives, seeded."""
    out = []
    for g in gts:
        boxes, labels = g['gt_bboxes_3d'], g['gt_labels_3d']
        det = boxes.copy()
        det[:, :3] += rng.normal(0, 0.08, (len(det), 3))
        det[::3] = boxes[::3]
        lab = labels.copy()
        lab[1::5] = (lab[1::5] + 1) % classes
        extra = boxes[:4].copy()
        extra[:, :2] += 2.5
        out.append(dict(bboxes=np.concatenate([det, extra]).astype(
                            np.float32),
                        scores=rng.uniform(0.05, 1, len(det) + 4),
                        labels=np.concatenate([lab, labels[:4]])))
    return out


def test_indoor_eval_matches_jax(indoor_set, monkeypatch):
    port, _ = datasets(SCANNET, indoor_set['root'] / 'scannet',
                       indoor_set['val'], 'val')
    gts = [port.get_ann_info(i) for i in range(len(port))]
    dts = predictions(np.random.RandomState(0), gts, 18)
    monkeypatch.setattr(jax_eval, '_iou_3d', port_eval._iou_3d)
    for thr in ((0.25, 0.5), (0.1, 0.7)):
        got = port_eval.indoor_eval(gts, dts, thr, port.CLASSES)
        want = jax_eval.indoor_eval(gts, dts, thr, port.CLASSES)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == pytest.approx(want[k], abs=1e-7), k
    assert 0.2 < got['mAP_0.10'] < 1 and got['mAR_0.10'] > 0.5
    assert port.evaluate(dts) == port_eval.indoor_eval(
        gts, dts, (0.25, 0.5), port.CLASSES)


TINY = '''
_base_ = '{base}'
model = dict(
    backbone=dict(num_points=(64, 32, 16, 8), num_samples=(8, 8, 8, 4),
                  sa_channels=((16, 16), (16, 32), (16, 32), (16, 32)),
                  fp_channels=((32, 32), (32, 32))),
    bbox_head=dict(num_proposals=16))
data = dict(
    samples_per_gpu=2, workers_per_gpu=0,
    train=dict(data_root='{root}/', ann_file='{train}'),
    val=dict(data_root='{root}/', ann_file='{val}'),
    test=dict(data_root='{root}/', ann_file='{val}'))
'''
# IndoorPointSample at 2,000 points (its place in each pipeline)
SAMPLE = {'train': 'data.train.pipeline.3.num_points=2000',
          'test': 'data.test.pipeline.1.num_points=2000'}


def test_votenet_clis_from_files(indoor_set, tmp_path, monkeypatch,
                                 one_thread):  # noqa: F811
    monkeypatch.chdir(tmp_path)
    config = str(tmp_path / 'votenet_tiny.py')
    with open(config, 'w') as f:
        f.write(TINY.format(base=SCANNET, root=indoor_set['root'] / 'scannet',
                            train=indoor_set['train'],
                            val=indoor_set['val']))
    run = train_cli.main([config, '--work-dir', str(tmp_path / 'work'),
                          '--max-steps', '2', '--device', 'cpu',
                          '--no-validate', '--cfg-options', SAMPLE['train']])
    assert run['step'] == 2 and len(run['batches'][0]) == 2
    assert set(run['batches'][0]) <= {'scene0000_00', 'scene0001_00'}
    run = test_cli.main([config, run['checkpoint'], '--eval', 'bbox',
                         '--device', 'cpu', '--cfg-options', SAMPLE['test']])
    assert len(run['results']) == 2
    metrics = run['metrics']
    for key in ('mAP_0.25', 'mAP_0.50', 'mAR_0.25', 'mAR_0.50'):
        assert np.isfinite(metrics[key]), key
    cfg = load_config(config)
    with DataLoader(run['dataset'], 1, shuffle=False, drop_last=False,
                    num_workers=0) as loader:
        batch = next(iter(loader))
    model = run['model']
    with torch.no_grad():
        direct, = unpack_detections(model.get_bboxes(model(
            *batch_model_inputs(cfg.model.type, batch, 'cpu'))))
    for key in ('bboxes', 'scores', 'labels'):
        assert np.array_equal(run['results'][0][key], direct[key]), key
