"""KITTI-format Waymo data and the KITTI and Waymo evaluators, port vs the
JAX package, on the CPU.

A KITTI-format Waymo set on disk (``chip_smoke.write_waymo``, the writer
of the card's phase 20: 6-float velodyne files, camera-frame annos with
``num_points_in_gt`` and a DontCare entry, a calibration that is not the
identity) of two small ``synth_scene.lc_batch`` frames, eight boxes each.

- ``KittiDataset``/``WaymoDataset``: ``get_data_info`` equal,
  ``get_ann_info`` within 1e-6 (and within 1e-5 of the LiDAR boxes
  written), ``load_interval``;
- the Waymo config's train pipeline from the files, exactly equal under
  equal seeds;
- ``bbox2result_kitti`` (float32 box conversions: within 1e-5 of each
  value's magnitude, names equal), the full KITTI protocol, the simplified
  BEV AP and the Waymo metrics: equal metric dicts on the same seeded
  detections; ``format_results``: the same bytes, which parse back to the
  detections;
- ``box_modes`` against the JAX package's eager calls and
  ``boxes_iou_bev`` against its jitted one (float32: within 1e-6 of the
  largest value, IoU within 1e-5); the simplified AP's JAX side on that
  jitted IoU too (eager it compiles op by op for every shape);
- port only: both CLIs on a tiny Waymo TransFusion-L from the files (a
  train step on the infos ``load_interval`` keeps; eval with the waymo
  metrics, its detections bit-equal to a direct forward; the ``.bin``
  parses to the detections) and the LC config without views, bit-equal
  to TransFusion-L on the same weights.
"""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as smoke
import msmdfusion_torch.datasets  # noqa: F401
import msmdfusion_tpu.datasets  # noqa: F401
from msmdfusion_torch.apis.inference import (batch_model_inputs,
                                             unpack_detections)
from msmdfusion_torch.config import load_config
from msmdfusion_torch.core import box_modes
from msmdfusion_torch.core.evaluation.waymo_serialize import \
    parse_objects_bin
from msmdfusion_torch.core.iou3d import boxes_iou_bev
from msmdfusion_torch.datasets.kitti import KittiDataset
from msmdfusion_torch.datasets.loader import DataLoader
from msmdfusion_torch.datasets.other_datasets import WaymoDataset
from msmdfusion_torch.models.builder import build_detector
from msmdfusion_torch.registry import DATASETS
from msmdfusion_torch.tools import test as test_cli
from msmdfusion_torch.tools import train as train_cli
from msmdfusion_torch.utils.checkpoint import save_checkpoint
from msmdfusion_torch.utils.synth_scene import LC_YAWS, lc_batch
from msmdfusion_tpu.core import box_modes as jax_box_modes
from msmdfusion_tpu.core.evaluation import kitti_metrics as jax_kitti_metrics
from msmdfusion_tpu.core.iou3d import boxes_iou_bev as jax_boxes_iou_bev
from msmdfusion_tpu.datasets.kitti import KittiDataset as JaxKittiDataset
from msmdfusion_tpu.datasets.other_datasets import \
    WaymoDataset as JaxWaymoDataset
from msmdfusion_tpu.registry import DATASETS as JAX_DATASETS
from tests.test_torch_bf16_train import one_thread  # noqa: F401
from tests.test_torch_datasets import assert_same

WAYMO_L = os.path.abspath('configs/transfusion_waymo_voxel_L.py')
WAYMO_LC = os.path.abspath('configs/transfusion_waymo_voxel_LC.py')
CLASSES = ['Car', 'Pedestrian', 'Cyclist']
PCR = [-20.0, -20.0, -2.0, 20.0, 20.0, 4.0]
COUNTS = dict(train=20, val=3)


def frame(seed, n_boxes=8):
    batch = lc_batch(dict(n=4000, img_hw=(8, 8), yaws=LC_YAWS['Waymo'],
                          pcr=PCR), seed=seed, return_gt=True,
                     num_classes=3, box_dim=7)
    gt = batch['gt']
    return (batch['points'][0], gt['gt_bboxes'][0][:n_boxes],
            gt['gt_labels'][0][:n_boxes])


@pytest.fixture(scope='module')
def waymo_set(tmp_path_factory):
    root = tmp_path_factory.mktemp('waymo')
    frames = [frame(0), frame(1)]
    paths = smoke.write_waymo(root, frames, COUNTS, CLASSES)
    return dict(root=root, frames=frames,
                **{k: str(v) for k, v in paths.items()})


def both(cls, jax_cls, waymo_set, split='val', **kwargs):
    args = dict(data_root=str(waymo_set['root']),
                ann_file=waymo_set[split], classes=CLASSES,
                test_mode=split == 'val', **kwargs)
    return cls(**copy.deepcopy(args)), jax_cls(**copy.deepcopy(args))


@pytest.mark.parametrize('name', ['KittiDataset', 'WaymoDataset'])
def test_infos_equal(waymo_set, name):
    classes = {'KittiDataset': (KittiDataset, JaxKittiDataset),
               'WaymoDataset': (WaymoDataset, JaxWaymoDataset)}[name]
    port, jax_ds = both(*classes, waymo_set, split='train')
    assert len(port) == len(jax_ds) == COUNTS['train']
    for i in range(len(port)):
        assert_same(port.get_data_info(i), jax_ds.get_data_info(i))
        got, want = port.get_ann_info(i), jax_ds.get_ann_info(i)
        assert np.array_equal(got['gt_labels_3d'], want['gt_labels_3d'])
        np.testing.assert_allclose(got['gt_bboxes_3d'], want['gt_bboxes_3d'],
                                   rtol=0, atol=1e-6)
        # the camera-frame annos read back to the LiDAR boxes written
        _, boxes, labels = waymo_set['frames'][i % 2]
        np.testing.assert_allclose(got['gt_bboxes_3d'], boxes, rtol=0,
                                   atol=1e-5)
        assert np.array_equal(got['gt_labels_3d'], labels)
    if name == 'WaymoDataset':
        port, jax_ds = both(*classes, waymo_set, split='train',
                            load_interval=5)
        assert len(port) == len(jax_ds) == COUNTS['train'] // 5
        assert [port.get_data_info(i)['sample_idx'] for i in
                range(len(port))] == list(range(0, COUNTS['train'], 5))


def test_waymo_train_pipeline_equal(waymo_set):
    root = str(waymo_set['root'])
    cfg = dict(load_config(WAYMO_L).data.train, data_root=root + '/',
               ann_file=waymo_set['train'])
    port = DATASETS.build(copy.deepcopy(cfg))
    jax_ds = JAX_DATASETS.build(copy.deepcopy(cfg))
    assert len(port) == COUNTS['train'] // 5
    for i in range(len(port)):
        got = port.sample(i, np.random.RandomState(7 + i))
        np.random.seed(7 + i)
        want = jax_ds[i]
        assert_same(got, want)
        assert got['gt_valid'].sum() > 0 and got['points_mask'].sum() > 0


def detections(waymo_set, seed=0):
    """Per val entry: its GT boxes moved by up to ~0.3 m, some dropped,
    two false positives, seeded scores (7-wide LiDAR boxes)."""
    rng = np.random.RandomState(seed)
    out = []
    for k in range(COUNTS['val']):
        _, boxes, labels = waymo_set['frames'][k % 2]
        keep = rng.rand(len(boxes)) < 0.85
        det = boxes[keep].copy()
        det[:, :3] += rng.normal(0, 0.1, (len(det), 3))
        det[:, 3:6] *= rng.uniform(0.9, 1.1, (len(det), 3))
        det[:, 6] += rng.normal(0, 0.1, len(det))
        fp = boxes[:2].copy()
        fp[:, :2] += 6.0
        out.append(dict(
            bboxes=np.concatenate([det, fp]).astype(np.float32),
            scores=rng.uniform(0.1, 1.0, len(det) + 2).astype(np.float32),
            labels=np.concatenate([labels[keep], labels[:2]]).astype(
                np.int64)))
    return out


def test_kitti_results_and_metrics_equal(waymo_set, monkeypatch):
    # the JAX package's simplified AP on its boxes_iou_bev jitted (eager,
    # it compiles op by op for each shape: ~18 s) and copied (the AP writes
    # into it, and np.asarray of a JAX array is read-only)
    iou = jax.jit(jax_boxes_iou_bev)

    def jax_iou(a, b):
        if len(a) == 0 or len(b) == 0:
            return np.zeros((len(a), len(b)), np.float32)
        return np.array(iou(jnp.asarray(a), jnp.asarray(b)))
    monkeypatch.setattr(jax_kitti_metrics, 'rotated_iou_bev_np', jax_iou)
    port, jax_ds = both(KittiDataset, JaxKittiDataset, waymo_set)
    dets = detections(waymo_set)[:1]
    got, want = port.bbox2result_kitti(dets), jax_ds.bbox2result_kitti(dets)
    assert sum(len(a['name']) for a in got) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w) and np.array_equal(g['name'], w['name'])
        for key in g:
            if key != 'name':
                scale = max(1.0, float(np.abs(w[key]).max(initial=0)))
                np.testing.assert_allclose(g[key], w[key], rtol=0,
                                           atol=1e-5 * scale, err_msg=key)
    for metric in ('kitti', 'bev'):
        got = port.evaluate(dets, metric=metric)
        want = jax_ds.evaluate(dets, metric=metric)
        assert got == want, metric
        assert any(v > 0 for v in got.values()), (metric, got)


def test_waymo_metrics_and_submission_equal(waymo_set, tmp_path):
    port, jax_ds = both(WaymoDataset, JaxWaymoDataset, waymo_set)
    dets = detections(waymo_set, seed=1)
    got, want = port.evaluate(dets), jax_ds.evaluate(dets)
    assert got == want and got['Waymo/L2/mAP'] > 0
    paths = [ds.format_results(dets, jsonfile_prefix=str(tmp_path / name))
             for ds, name in ((port, 'port'), (jax_ds, 'jax'))]
    data = [open(p, 'rb').read() for p in paths]
    assert data[0] == data[1]
    objs = parse_objects_bin(data[0])
    assert len(objs) == sum(len(d['scores']) for d in dets)
    assert {o['context_name'] for o in objs} == {'segment-0', 'segment-1'}


def test_box_modes_and_iou_bev_match_jax():
    rng = np.random.RandomState(3)
    boxes = np.concatenate([rng.uniform(-20, 20, (16, 3)),
                            rng.uniform(0.5, 5, (16, 3)),
                            rng.uniform(-np.pi, np.pi, (16, 1)),
                            rng.normal(size=(16, 2))], 1).astype(np.float32)
    rt = np.asarray(smoke.waymo_calib()['Tr_velo_to_cam'][:3])
    points = rng.uniform(-10, 10, (50, 4)).astype(np.float32)
    modes = box_modes
    cases = [
        ('convert_boxes', (boxes, modes.LIDAR, modes.CAM, rt)),
        ('convert_boxes', (boxes, modes.LIDAR, modes.CAM)),
        ('convert_boxes', (boxes, modes.CAM, modes.LIDAR)),
        ('convert_boxes', (boxes, modes.LIDAR, modes.DEPTH)),
        ('convert_points', (points, modes.DEPTH, modes.CAM, rt[:, :3])),
        ('convert_points', (points, modes.CAM, modes.DEPTH, rt[:, :3])),
        ('convert_points', (points, modes.LIDAR, modes.CAM)),
        ('cam_corners_3d', (boxes[:, :7],)),
    ]
    for name, args in cases:
        got = getattr(box_modes, name)(*args)
        want = np.asarray(getattr(jax_box_modes, name)(*args))
        assert got.dtype == want.dtype == np.float32 and \
            got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max(),
                                   err_msg=name)
    bev = boxes[:, [0, 1, 3, 4, 6]] * np.float32([0.2, 0.2, 1, 1, 1])
    got = boxes_iou_bev(torch.from_numpy(bev[:10]),
                        torch.from_numpy(bev[6:])).numpy()
    want = np.asarray(jax.jit(jax_boxes_iou_bev)(jnp.asarray(bev[:10]),
                                                 jnp.asarray(bev[6:])))
    assert (want > 0.01).sum() > 4
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


TINY = '''
_base_ = '{base}'
voxel_size = [2.35, 2.35, 0.15]
model = dict(
    pts_voxel_layer=dict(voxel_size=voxel_size, max_voxels=(20000, 20000)),
    pts_middle_encoder=dict(
        sparse_shape=[41, 64, 64], base_channels=4, output_channels=8,
        encoder_channels=((4, 4, 8), (8, 8, 8), (8, 8, 8), (8, 8)),
        stage_capacities=[20000, 10000, 5000, 5000]),
    pts_backbone=dict(in_channels=16, out_channels=[8, 16]),
    pts_neck=dict(in_channels=[8, 16], out_channels=[8, 8]),
    pts_bbox_head=dict(num_proposals=10, in_channels=16, hidden_channel=16,
                       num_heads=2, ffn_channel=32,
                       bbox_coder=dict(voxel_size=voxel_size[:2])),
    train_cfg=dict(pts=dict(grid_size=[64, 64, 40], voxel_size=voxel_size)),
    test_cfg=dict(pts=dict(grid_size=[64, 64, 40],
                           voxel_size=voxel_size[:2])))
data = dict(
    workers_per_gpu=0,
    train=dict(data_root='{root}/', ann_file='{root}/waymo_infos_train.pkl'),
    val=dict(data_root='{root}/', ann_file='{root}/waymo_infos_val.pkl'),
    test=dict(data_root='{root}/', ann_file='{root}/waymo_infos_val.pkl'))
'''
TINY_LC = '''
model['img_backbone'] = dict(depth=18)
model['img_neck'] = dict(in_channels=[64, 128, 256, 512], out_channels=16)
model['pts_bbox_head']['in_channels_img'] = 16
'''


def test_waymo_clis_from_files(waymo_set, tmp_path, monkeypatch,
                               one_thread):  # noqa: F811
    monkeypatch.chdir(tmp_path)
    root = str(waymo_set['root'])
    configs = {}
    for name, base, extra in (('L', WAYMO_L, ''), ('LC', WAYMO_LC, TINY_LC)):
        configs[name] = str(tmp_path / f'waymo_{name}.py')
        with open(configs[name], 'w') as f:
            f.write(TINY.format(base=base, root=root) + extra)
    # PadPoints at the frames' sizes (the configs pad to 180,000 points)
    cpu = ['--device', 'cpu', '--cfg-options',
           'data.test.pipeline.2.max_points=4096']
    run = train_cli.main([configs['L'], '--work-dir', str(tmp_path / 'work'),
                          '--max-steps', '1', '--device', 'cpu',
                          '--cfg-options',
                          'data.train.pipeline.8.max_points=8192'])
    assert run['step'] == 1 and len(run['batches'][0]) == 2
    assert set(run['batches'][0]) < {0, 5, 10, 15}
    ckpt = run['checkpoint']

    run = test_cli.main([configs['L'], ckpt, '--eval', 'waymo', *cpu])
    metrics = run['metrics']
    assert len(run['results']) == COUNTS['val']
    assert metrics['protocol'] == 'native-proxy' and all(
        np.isfinite(v) for k, v in metrics.items() if k != 'protocol')
    cfg = load_config(configs['L'])
    with DataLoader(run['dataset'], 1, shuffle=False, drop_last=False,
                    num_workers=0) as loader:
        batch = next(iter(loader))
    with torch.no_grad():
        model = run['model']
        direct, = unpack_detections(model.get_bboxes(model(
            *batch_model_inputs(cfg.model.type, batch, 'cpu'))))
    for key in ('bboxes', 'scores', 'labels'):
        assert np.array_equal(run['results'][0][key], direct[key]), key
    results = run['results']

    run = test_cli.main([configs['L'], ckpt, '--format-only', *cpu])
    with open(run['submission'], 'rb') as f:
        assert len(parse_objects_bin(f.read())) == sum(
            len(r['scores']) for r in results) > 0

    lc = build_detector(load_config(configs['LC']).model, device='cpu')
    missing, unexpected = lc.load_state_dict(model.state_dict(),
                                             strict=False)
    assert missing and not unexpected
    lc_ckpt = save_checkpoint(str(tmp_path / 'lc'), 0, lc)
    run = test_cli.main([configs['LC'], lc_ckpt, *cpu])
    for got, want in zip(run['results'], results):
        for key in ('bboxes', 'scores', 'labels'):
            assert np.array_equal(got[key], want[key]), key
