"""GT paste and the GT database, port vs the JAX package, on the CPU.

A tiny nuScenes-layout set on disk (``write_frames``: keyframes with two
sweeps each, every GT box holding a cluster of points): the database
frames, from which both packages' ``create_gt_database`` crop the GT
clusters, and the train frames, whose boxes lie elsewhere, so that pastes
happen. Every comparison is exact (numpy on both sides, the same
arithmetic):

- ``box_np_ops`` and ``aug_utils`` against the JAX package's, the noise
  drawn from equal ``RandomState``s on both sides;
- the database: equal index dicts and byte-equal cluster files, also
  through ``python -m msmdfusion_torch.tools.create_data
  --with-gt-database`` from the train info pickle on disk, and the tool's
  refusals without nuscenes-devkit (no info pickle there; ``kitti``);
- one ``ObjectSample`` call drawing from ``RandomState(s)`` against
  ``np.random.seed(s)`` and a freshly built JAX ``ObjectSample`` (the
  port draws per sample what a fresh JAX sampler draws on its first
  call): boxes, labels and points bit-equal, the generators left in the
  same state, pastes above 0; ``ObjectNoise`` likewise;
- the stage-1 train pipeline (``configs/transfusion_nusc_voxel_L.py``'s
  transforms at the tiny set's sizes) under equal seeds, the JAX
  ``ObjectSample`` rebuilt after each seed;
- the ``stop_epoch`` fade: nothing pasted and nothing drawn from it on;
- the loader over CBGS with the paste at 0 and 2 worker processes: equal
  batches, pastes in epoch 0 and none in epoch 1 (the epoch reaches the
  workers' copies of the dataset).
"""
import copy
import importlib.util
import os
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import msmdfusion_torch.datasets  # noqa: F401
import msmdfusion_tpu.datasets  # noqa: F401
from msmdfusion_torch.core import box_np_ops
from msmdfusion_torch.datasets.custom_3d import CBGSDataset
from msmdfusion_torch.datasets.loader import DataLoader
from msmdfusion_torch.datasets.nuscenes import NuScenesDataset
from msmdfusion_torch.datasets.pipelines import aug_utils
from msmdfusion_torch.datasets.pipelines.transforms_3d import (ObjectNoise,
                                                               ObjectSample)
from msmdfusion_torch.registry import DATASETS
from msmdfusion_torch.tools import create_data
from msmdfusion_tpu.core import box_np_ops as jax_box_np_ops
from msmdfusion_tpu.datasets.pipelines import aug_utils as jax_aug_utils
from msmdfusion_tpu.datasets.pipelines.dbsampler import \
    DataBaseSampler as JaxDataBaseSampler
from msmdfusion_tpu.datasets.pipelines.transforms_3d import \
    ObjectNoise as JaxObjectNoise
from msmdfusion_tpu.datasets.pipelines.transforms_3d import \
    ObjectSample as JaxObjectSample
from msmdfusion_tpu.registry import DATASETS as JAX_DATASETS
from tests.test_torch_datasets import assert_same

REPO = Path(__file__).resolve().parents[1]
CLASSES = list(NuScenesDataset.CLASSES)
PCR = [-12.0, -12.0, -3.0, 12.0, 12.0, 3.0]
# configs/transfusion_nusc_voxel_L.py's db_sampler, its files the tiny set's
SAMPLE_GROUPS = dict(car=2, truck=3, construction_vehicle=7, bus=4,
                     trailer=6, barrier=2, motorcycle=6, bicycle=6,
                     pedestrian=2, traffic_cone=2)


def write_frames(root, names, seed, n_boxes=8, sweeps=2):
    """Frames ``names`` in the nuScenes layout under ``root``: per frame a
    keyframe .bin of background points and a 40-point cluster in each of
    ``n_boxes`` boxes, ``sweeps`` sweep files, and its info; returns the
    infos."""
    rng = np.random.RandomState(seed)
    (root / 'samples').mkdir(parents=True, exist_ok=True)
    (root / 'sweeps').mkdir(parents=True, exist_ok=True)
    infos = []
    for i, name in enumerate(names):
        boxes = np.zeros((n_boxes, 7), np.float32)
        boxes[:, :2] = rng.uniform(-10, 10, (n_boxes, 2))
        boxes[:, 2] = -1.5
        boxes[:, 3:6] = rng.uniform([0.6, 0.6, 1.0], [2.0, 4.5, 2.0],
                                    (n_boxes, 3))
        boxes[:, 6] = rng.uniform(-np.pi, np.pi, n_boxes)
        chunks = [np.concatenate([rng.uniform(-12, 12, (600, 2)),
                                  rng.uniform(-2, 1, (600, 1))], 1)]
        for b in boxes:
            local = rng.uniform(-0.45, 0.45, (40, 3)) * b[3:6]
            local[:, 2] += 0.5 * b[5]
            c, s = np.cos(b[6]), np.sin(b[6])
            chunks.append(np.stack([c * local[:, 0] - s * local[:, 1],
                                    s * local[:, 0] + c * local[:, 1],
                                    local[:, 2]], 1) + b[:3])
        xyz = np.concatenate(chunks)
        pts = np.concatenate([xyz, rng.rand(len(xyz), 1),
                              np.zeros((len(xyz), 1))], 1).astype(np.float32)
        path = root / 'samples' / f'{name}.bin'
        pts.tofile(path)
        ts = 1_000_000 * (i + 1)
        sweep_infos = []
        for j in range(sweeps):
            sp = root / 'sweeps' / f'{name}_{j}.bin'
            pts[rng.rand(len(pts)) < 0.5].tofile(sp)
            sweep_infos.append(dict(
                data_path=str(sp), timestamp=ts - 50_000 * (j + 1),
                sensor2lidar_rotation=np.eye(3),
                sensor2lidar_translation=np.zeros(3)))
        infos.append(dict(
            token=name, lidar_path=str(path), timestamp=ts,
            sweeps=sweep_infos, gt_boxes=boxes,
            gt_names=np.array([CLASSES[k] for k in
                               rng.randint(0, len(CLASSES), n_boxes)]),
            gt_velocity=rng.normal(0, 1, (n_boxes, 2)).astype(np.float32)))
    return infos


def dump(path, infos):
    with open(path, 'wb') as f:
        pickle.dump(dict(infos=infos, metadata=dict(version='v1.0-mini')), f)


def jax_tool():
    """The repository's ``tools/create_data.py`` (not a package)."""
    spec = importlib.util.spec_from_file_location(
        '_jax_create_data', REPO / 'tools' / 'create_data.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope='module')
def gt_set(tmp_path_factory):
    """dict(root, db: the port's database index, train: the train frames'
    info file, db_sampler: the config's sampler on the tiny set)."""
    root = tmp_path_factory.mktemp('nuscenes')
    dump(root / 'nuscenes_infos_train.pkl',
         write_frames(root, [f'db{i}' for i in range(3)], seed=1))
    dump(root / 'train_infos.pkl',
         write_frames(root, [f'frame{i}' for i in range(4)], seed=2))
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, 'nuscenes', None)   # no devkit
        done = create_data.main(['nuscenes', '--root-path', str(root),
                                 '--with-gt-database'])
    db = done['gt_database']
    assert db == str(root / 'nuscenes_dbinfos_train.pkl') and not done['infos']
    sampler = dict(
        data_root=str(root) + '/', info_path=db, rate=1.0,
        prepare=dict(filter_by_difficulty=[-1],
                     filter_by_min_points={c: 5 for c in CLASSES}),
        classes=CLASSES, sample_groups=SAMPLE_GROUPS)
    return dict(root=root, db=db, train=str(root / 'train_infos.pkl'),
                db_sampler=sampler)


def test_box_np_ops_equal():
    rng = np.random.RandomState(0)
    boxes = np.concatenate([rng.uniform(-5, 5, (9, 3)),
                            rng.uniform(0.5, 3, (9, 3)),
                            rng.uniform(-np.pi, np.pi, (9, 1))], 1)
    points = rng.uniform(-6, 6, (200, 4))
    rect = np.eye(4)
    rect[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    velo2cam = np.eye(4)
    velo2cam[:3] = rng.normal(size=(3, 4))
    corners = box_np_ops.center_to_corner_box2d(boxes[:, :2], boxes[:, 3:5],
                                                boxes[:, 6])
    cases = [
        ('corners_bev_np', (boxes[:, [0, 1, 3, 4, 6]],)),
        ('points_in_rbbox_np', (points, boxes)),
        ('center_to_corner_box2d', (boxes[:, :2], boxes[:, 3:5],
                                    boxes[:, 6])),
        ('corner_to_standup_nd', (corners,)),
        ('rotation_points_single_angle', (points, 0.7, 2)),
        ('box_camera_to_lidar', (boxes, rect, velo2cam)),
        ('box_lidar_to_camera', (boxes, rect, velo2cam)),
    ]
    for name, args in cases:
        got = getattr(box_np_ops, name)(*args)
        want = getattr(jax_box_np_ops, name)(*args)
        for g, w in zip(*(x if isinstance(x, tuple) else (x,)
                          for x in (got, want))):
            assert np.array_equal(g, w), name
    qcorners = box_np_ops.center_to_corner_box2d(
        boxes[:4, :2] + 0.5, boxes[:4, 3:5], boxes[:4, 6] + 0.3)
    got = aug_utils.box_collision_test(corners, qcorners)
    assert got.any() and np.array_equal(
        got, jax_aug_utils.box_collision_test(corners, qcorners))


@pytest.mark.parametrize('seed', [0, 1])
def test_noise_per_object_equal(seed):
    """``noise_per_object_v3`` with a ``RandomState`` on both sides, and
    ``ObjectNoise`` against the JAX transform on the global generator:
    boxes and points bit-equal; some boxes moved."""
    rng = np.random.RandomState(10 + seed)
    boxes = np.concatenate([rng.uniform(-6, 6, (10, 2)),
                            np.full((10, 1), -1.0),
                            rng.uniform(0.5, 3, (10, 3)),
                            rng.uniform(-np.pi, np.pi, (10, 1)),
                            np.zeros((10, 2))], 1).astype(np.float32)
    points = np.concatenate([rng.uniform(-7, 7, (500, 2)),
                             rng.uniform(-1, 1, (500, 1)),
                             rng.rand(500, 2)], 1).astype(np.float32)
    runs = []
    for noise in (aug_utils.noise_per_object_v3,
                  jax_aug_utils.noise_per_object_v3):
        b, p = boxes.copy(), points.copy()
        noise(b, p, rotation_perturb=[-0.3, 0.3],
              center_noise_std=[1.0, 1.0, 0.0],
              global_random_rot_range=[0.0, 0.0], num_try=20,
              rng=np.random.RandomState(seed))
        runs.append((b, p))
    (b, p), (jb, jp) = runs
    assert np.array_equal(b, jb) and np.array_equal(p, jp)
    assert (b != boxes).any() and (p != points).any()

    cfg = dict(translation_std=[1.0, 1.0, 0.0], rot_range=[-0.3, 0.3],
               num_try=20)
    got = ObjectNoise(**cfg)(dict(points=points.copy(),
                                  gt_bboxes_3d=boxes.copy()),
                             np.random.RandomState(seed))
    np.random.seed(seed)
    want = JaxObjectNoise(**cfg)(dict(points=points.copy(),
                                      gt_bboxes_3d=boxes.copy()))
    assert_same(got, want)
    with pytest.raises(ValueError, match='RandomState'):
        aug_utils.noise_per_object_v3(boxes.copy(), points.copy(),
                                      global_random_rot_range=0.0)


def test_gt_database_equal(gt_set, tmp_path):
    """The JAX tool's ``create_gt_database`` over the same infos: equal
    index dicts, byte-equal cluster files; only the index's name differs
    (the config's ``nuscenes_dbinfos_train.pkl`` here)."""
    root = gt_set['root']
    want_index = jax_tool().create_gt_database(
        str(root), str(root / 'nuscenes_infos_train.pkl'), str(tmp_path),
        CLASSES)
    assert os.path.basename(want_index) == 'dbinfos_train.pkl'
    with open(gt_set['db'], 'rb') as f:
        got = pickle.load(f)
    with open(want_index, 'rb') as f:
        want = pickle.load(f)
    assert_same(got, want)
    clusters = sorted(os.listdir(root / 'gt_database'))
    assert clusters == sorted(os.listdir(tmp_path / 'gt_database'))
    assert len(clusters) == sum(map(len, got.values())) == 24
    for name in clusters:
        assert (root / 'gt_database' / name).read_bytes() == \
            (tmp_path / 'gt_database' / name).read_bytes(), name
    assert all(e['num_points_in_gt'] >= 40 for v in got.values() for e in v)


def test_create_data_refusals(tmp_path, monkeypatch):
    """Without nuscenes-devkit the info step stops with the repository
    tool's message, also under ``--with-gt-database`` where no train info
    pickle is on disk; ``kitti`` is refused as there."""
    monkeypatch.setitem(sys.modules, 'nuscenes', None)
    for extra in ([], ['--with-gt-database']):
        with pytest.raises(SystemExit, match='nuscenes-devkit is required'):
            create_data.main(['nuscenes', '--root-path', str(tmp_path),
                              *extra])
    with pytest.raises(SystemExit, match='kitti_infos pickles'):
        create_data.main(['kitti', '--root-path', str(tmp_path)])
    assert not list(tmp_path.iterdir())


def train_results(gt_set, i):
    """A train frame's loaded points and GT (nuScenes boxes with their
    velocity), as ObjectSample gets them."""
    with open(gt_set['train'], 'rb') as f:
        info = pickle.load(f)['infos'][i]
    pts = np.fromfile(info['lidar_path'], np.float32).reshape(-1, 5)
    boxes = np.concatenate([info['gt_boxes'], info['gt_velocity']], 1)
    labels = np.array([CLASSES.index(n) for n in info['gt_names']], np.int64)
    return dict(points=pts, gt_bboxes_3d=boxes.astype(np.float32),
                gt_labels_3d=labels)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_object_sample_equal(gt_set, seed):
    results = train_results(gt_set, seed)
    rng = np.random.RandomState(seed)
    got = ObjectSample(db_sampler=dict(gt_set['db_sampler']))(
        copy.deepcopy(results), rng)
    np.random.seed(seed)
    want = JaxObjectSample(db_sampler=dict(gt_set['db_sampler']))(
        copy.deepcopy(results))
    objects, points = got.pop('gt_paste')
    assert_same(got, want)
    n = len(results['gt_bboxes_3d'])
    assert objects == len(got['gt_bboxes_3d']) - n > 0 and points >= \
        40 * objects
    # the same draws: the generators are left in the same state
    state, want_state = rng.get_state(), np.random.get_state()
    assert state[2] == want_state[2] and np.array_equal(state[1],
                                                        want_state[1])


def test_object_sample_fade(gt_set):
    op = ObjectSample(db_sampler=dict(gt_set['db_sampler']), stop_epoch=2)
    results = train_results(gt_set, 0)
    for epoch in range(4):
        op.set_epoch(epoch)
        rng = np.random.RandomState(0)
        out = op(copy.deepcopy(results), rng)
        pasted = epoch < 2
        assert (out['gt_paste'][0] > 0) == pasted
        assert (len(out['gt_bboxes_3d']) > len(results['gt_bboxes_3d'])) \
            == pasted
        if not pasted:
            assert_same(out, dict(results, gt_paste=np.zeros(2, np.int64)))
            assert rng.randint(1 << 30) == np.random.RandomState(
                0).randint(1 << 30)


def stage1_pipeline(db_sampler, stop_epoch=None):
    """configs/transfusion_nusc_voxel_L.py's train pipeline at the tiny
    set's sizes: two sweeps, its range, 4096 points, 64 boxes."""
    return [
        dict(type='LoadPointsFromFile', coord_type='LIDAR', load_dim=5,
             use_dim=[0, 1, 2, 3, 4]),
        dict(type='LoadPointsFromMultiSweeps', sweeps_num=2,
             use_dim=[0, 1, 2, 3, 4]),
        dict(type='LoadAnnotations3D', with_bbox_3d=True,
             with_label_3d=True),
        dict(type='ObjectSample', db_sampler=db_sampler,
             stop_epoch=stop_epoch),
        dict(type='GlobalRotScaleTrans', rot_range=[-0.785, 0.785],
             scale_ratio_range=[0.9, 1.1], translation_std=[0.5, 0.5, 0.5]),
        dict(type='RandomFlip3D', sync_2d=False,
             flip_ratio_bev_horizontal=0.5, flip_ratio_bev_vertical=0.5),
        dict(type='PointsRangeFilter', point_cloud_range=PCR),
        dict(type='ObjectRangeFilter', point_cloud_range=PCR),
        dict(type='ObjectNameFilter', classes=CLASSES),
        dict(type='PointShuffle'),
        dict(type='PadPoints', max_points=4096),
        dict(type='PadGroundTruth', max_gt=64),
        dict(type='FormatBundle3D', class_names=CLASSES),
    ]


def train_set_cfg(gt_set, stop_epoch=None):
    return dict(type='NuScenesDataset', data_root=str(gt_set['root']),
                ann_file=gt_set['train'], classes=CLASSES,
                pipeline=stage1_pipeline(gt_set['db_sampler'], stop_epoch),
                modality=dict(use_lidar=True), test_mode=False)


def test_stage1_pipeline_equal(gt_set):
    cfg = train_set_cfg(gt_set)
    port = DATASETS.build(copy.deepcopy(cfg))
    jax_ds = JAX_DATASETS.build(copy.deepcopy(cfg))
    paste, = [t for t in jax_ds.pipeline.transforms
              if isinstance(t, JaxObjectSample)]
    for i in range(len(port)):
        got = port.sample(i, np.random.RandomState(100 + i))
        np.random.seed(100 + i)
        paste.db_sampler = JaxDataBaseSampler(**gt_set['db_sampler'])
        want = jax_ds[i]
        assert got['metas'].pop('gt_paste')[0] > 0
        assert_same(got, want)


def test_loader_pastes_alike_with_workers(gt_set):
    """CBGS over the stage-1 pipeline with ``stop_epoch`` 1: the batches
    of epochs 0 and 1 at 0 and at 2 worker processes are equal; epoch 0
    pastes in every sample, epoch 1 in none."""
    runs = []
    for workers in (0, 2):
        ds = CBGSDataset(train_set_cfg(gt_set, stop_epoch=1), seed=0)
        with DataLoader(ds, 2, seed=3, num_workers=workers) as loader:
            epochs = []
            for epoch in (0, 1):
                loader.set_epoch(epoch)
                epochs.append(list(loader))
        runs.append(epochs)
    assert len(runs[0][0]) >= 2
    for epoch, (got, want) in enumerate(zip(*runs)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for key in ('points', 'points_mask', 'gt_bboxes_3d',
                        'gt_labels_3d', 'gt_valid'):
                assert torch.equal(g[key], w[key]), (epoch, key)
            pastes = [m['gt_paste'] for m in g['metas']]
            assert all(np.array_equal(p, m['gt_paste'])
                       for p, m in zip(pastes, w['metas']))
            assert all((p > 0).all() if epoch == 0 else not p.any()
                       for p in pastes), (epoch, pastes)
