"""The port's nuScenes data pipeline against the JAX package's.

Same info files and artifacts on disk (``multimodal_dataset`` of
``tests/test_flagship_pipeline.py``, ``synthetic_dataset`` of
``tests/test_train_cli.py``); JAX's global numpy generator and the port's
``np.random.RandomState`` seeded alike, so both pipelines draw the same
numbers in the same order. Every array and meta must be exactly equal;
the normalised images within one grey level (the resize is a port of
PIL's ``BILINEAR``: here it gives PIL's values exactly). No JAX function
is compiled: the JAX pipeline is numpy.
"""
import copy
import json

import numpy as np
import pytest

import msmdfusion_torch.datasets  # noqa: F401
import msmdfusion_tpu.datasets  # noqa: F401
from msmdfusion_torch.config import load_config
from msmdfusion_torch.datasets.pipelines.loading import pil_bilinear_resize
from msmdfusion_torch.registry import DATASETS, PIPELINES
from msmdfusion_torch.utils import overflow
from msmdfusion_tpu.registry import DATASETS as JAX_DATASETS
from msmdfusion_tpu.registry import PIPELINES as JAX_PIPELINES
from tests.test_flagship_pipeline import multimodal_dataset  # noqa: F401
from tests.test_train_cli import synthetic_dataset  # noqa: F401

# the flagship config's test pipeline at the fixture's sizes
TEST_PIPELINE = [
    dict(type='LoadPointsFromFile', coord_type='LIDAR', load_dim=5,
         use_dim=[0, 1, 2, 3, 4]),
    dict(type='LoadPointsFromMultiSweeps', sweeps_num=2,
         use_dim=[0, 1, 2, 3, 4]),
    dict(type='LoadMultiViewImageFromFiles'),
    dict(type='LoadForeground2D', dataset='NuScenesDataset'),
    dict(type='LoadForeground2DFromMultiSweeps', dataset='NuScenesDataset',
         sweeps_num=2),
    dict(type='GlobalRotTransFilterForeground2D',
         point_cloud_range=[-4.8, -4.8, -4.0, 4.8, 4.8, 4.0]),
    dict(type='MyResize', img_scale=(64, 32), keep_ratio=True),
    dict(type='MyNormalize', mean=[123.675, 116.28, 103.53],
         std=[58.395, 57.12, 57.375], to_rgb=True),
    dict(type='MyPad', size_divisor=32),
    dict(type='ImgScaleCropFlipForeground2D'),
    dict(type='PadPoints', max_points=512),
    dict(type='PadForeground2D', max_points=64, max_real_points=32),
    dict(type='FormatBundle3D', with_label=False),
]
STD = np.float32([58.395, 57.12, 57.375])


def assert_same(got, want, where='sample'):
    """Exactly equal: the same keys, types, shapes, dtypes and bits."""
    if isinstance(want, dict):
        assert set(got) == set(want), (where, set(got) ^ set(want))
        for k in want:
            assert_same(got[k], want[k], f'{where}.{k}')
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f'{where}[{i}]')
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), where
        assert got.dtype == want.dtype and got.shape == want.shape, \
            (where, got.dtype, want.dtype, got.shape, want.shape)
        assert np.array_equal(got, want, equal_nan=want.dtype.kind == 'f'), \
            where
    else:
        assert type(got) is type(want) and got == want, (where, got, want)


def both(cfg_path, key='train', **changes):
    """(port dataset, JAX dataset) of the config's ``data[key]``."""
    cfg = dict(load_config(cfg_path).data[key], **changes)
    return DATASETS.build(copy.deepcopy(cfg)), \
        JAX_DATASETS.build(copy.deepcopy(cfg))


def held_images(got, want):
    """The normalised views within one grey level; (largest difference
    in grey levels, share of equal values)."""
    diff = np.abs(got.astype(np.float64) - want) * STD
    assert diff.max() <= 1.0 + 1e-3, diff.max()
    return float(diff.max()), float((got == want).mean())


@pytest.mark.parametrize('split', ['train', 'test'])
def test_flagship_pipeline_equal(multimodal_dataset, split):  # noqa: F811
    _, cfg_path = multimodal_dataset
    changes = {} if split == 'train' else dict(
        pipeline=TEST_PIPELINE, test_mode=True)
    port, jax_ds = both(cfg_path, **changes)
    for i in range(len(port)):
        np.random.seed(100 + i)
        want = jax_ds[i]
        got = port.sample(i, np.random.RandomState(100 + i))
        worst, share = held_images(got.pop('img'), want.pop('img'))
        assert (worst, share) == (0.0, 1.0), (worst, share)
        assert_same(got, want)
        assert got['foreground']['fg_mask'].any()
        assert got['metas']['scale_factor'][0] == 0.5


@pytest.mark.parametrize('shape', [(900, 1600, 448, 796), (64, 64, 32, 32),
                                   (37, 53, 20, 31), (30, 40, 60, 90)])
def test_bilinear_resize_is_pils(shape):
    """The flagship's 900 x 1600 views -> 448 x 796 (and odd sizes, an
    upscale) against PIL's BILINEAR: largest difference 0 grey levels,
    every value equal."""
    from PIL import Image
    h, w, nh, nw = shape
    img = np.random.RandomState(0).randint(0, 256, (2, h, w, 3)).astype(
        np.uint8)
    got = pil_bilinear_resize(img, nh, nw)
    want = np.stack([np.asarray(Image.fromarray(im).resize(
        (nw, nh), Image.BILINEAR)) for im in img])
    diff = np.abs(got.astype(int) - want)
    assert got.shape == want.shape and diff.max() <= 1
    assert diff.max() == 0 and (diff == 0).mean() == 1.0


def _sweep_files(tmp_path, rng, n=5):
    sweeps = []
    for i in range(n):
        path = tmp_path / f'sweep{i}.bin'
        rng.uniform(-5, 5, (50, 5)).astype(np.float32).tofile(str(path))
        c, s = np.cos(0.1 * i), np.sin(0.1 * i)
        sweeps.append(dict(
            data_path=str(path), timestamp=(10 - i) * 1e5,
            sensor2lidar_rotation=np.array([[c, -s, 0], [s, c, 0],
                                            [0, 0, 1]]),
            sensor2lidar_translation=np.array([0.1 * i, 0.0, 0.05])))
    return sweeps


def _results(tmp_path, rng):
    """A mid-pipeline results dict: points, 9-wide boxes, labels, sweeps,
    per-camera foreground lists."""
    fg = dict(fg_points=[rng.randn(n, 15).astype(np.float32)
                         for n in (7, 0, 12)],
              fg_pixels=[rng.rand(n, 3).astype(np.float32)
                         for n in (7, 0, 12)])
    return dict(points=rng.randn(80, 5).astype(np.float32),
                gt_bboxes_3d=rng.randn(6, 9).astype(np.float32),
                gt_labels_3d=rng.randint(0, 10, 6),
                sweeps=_sweep_files(tmp_path, rng), timestamp=1e6,
                foreground2D_info=fg)


RANDOM_TRANSFORMS = [
    dict(type='GlobalRotScaleTrans', rot_range=[-0.785, 0.785],
         scale_ratio_range=[0.9, 1.1], translation_std=[0.5, 0.5, 0.5]),
    dict(type='RandomFlip3D', sync_2d=False, flip_ratio_bev_horizontal=0.5,
         flip_ratio_bev_vertical=0.5),
    dict(type='PointShuffle'),
    dict(type='ShuffleForeground2D'),
    dict(type='LoadPointsFromMultiSweeps', sweeps_num=2,
         use_dim=[0, 1, 2, 3, 4]),
]


@pytest.mark.parametrize('cfg', RANDOM_TRANSFORMS,
                         ids=[c['type'] for c in RANDOM_TRANSFORMS])
def test_random_transform_equal(cfg, tmp_path):
    results = _results(tmp_path, np.random.RandomState(1))
    port, jax_t = PIPELINES.build(dict(cfg)), JAX_PIPELINES.build(dict(cfg))
    flips = set()
    for seed in range(8):
        np.random.seed(seed)
        want = jax_t(copy.deepcopy(results))
        got = port(copy.deepcopy(results), np.random.RandomState(seed))
        assert_same(got, want)
        flips.add((want.get('pcd_horizontal_flip'),
                   want.get('pcd_vertical_flip')))
    if cfg['type'] == 'RandomFlip3D':
        assert len(flips) == 4           # every branch was taken
    with pytest.raises(ValueError, match=cfg['type']):
        port(copy.deepcopy(results), None)


def test_data_and_ann_info_equal(multimodal_dataset):  # noqa: F811
    _, cfg_path = multimodal_dataset
    port, jax_ds = both(cfg_path)
    for i in range(len(port)):
        assert_same(port.get_data_info(i), jax_ds.get_data_info(i))
        assert_same(port.get_ann_info(i), jax_ds.get_ann_info(i))
        assert port.get_cat_ids(i) == jax_ds.get_cat_ids(i)
    assert port.get_data_info(0)['lidar2img'].shape == (6, 4, 4)


def test_cbgs_indices_equal(synthetic_dataset):  # noqa: F811
    _, cfg_path = synthetic_dataset
    # the classes the samples hold: with all ten nuScenes classes and
    # three present, CBGS keeps int(n * 0.1 / share) = 0 of each
    inner = dict(load_config(cfg_path).data.train,
                 classes=['car', 'truck', 'pedestrian'])
    np.random.seed(0)
    want = JAX_DATASETS.build(dict(type='CBGSDataset',
                                   dataset=copy.deepcopy(inner)))
    got = DATASETS.build(dict(type='CBGSDataset', seed=0,
                              dataset=copy.deepcopy(inner)))
    assert [int(i) for i in got.sample_indices] == \
        [int(i) for i in want.sample_indices]
    assert len(got) > len(got.dataset)


def _detections(rng, n_samples, n=12):
    out = []
    for _ in range(n_samples):
        boxes = np.concatenate([rng.uniform(-4, 4, (n, 2)),
                                rng.uniform(-2, 0, (n, 1)),
                                rng.uniform(0.5, 2, (n, 3)),
                                rng.uniform(-3, 3, (n, 1)),
                                rng.uniform(-1, 1, (n, 2))], 1)
        out.append(dict(bboxes=boxes.astype(np.float32),
                        scores=rng.rand(n).astype(np.float32),
                        labels=rng.randint(0, 10, n)))
    return out


def test_format_results_and_metrics_equal(synthetic_dataset, tmp_path,
                                          monkeypatch):  # noqa: F811
    _, cfg_path = synthetic_dataset
    monkeypatch.chdir(tmp_path)
    port, jax_ds = both(cfg_path, 'val')
    rng = np.random.RandomState(3)
    for ds in (port, jax_ds):     # calibrated poses on half the samples
        for info in ds.data_infos[::2]:
            info['lidar2ego_rotation'] = [0.99, 0.01, -0.02, 0.1]
            info['lidar2ego_translation'] = [1.0, 0.0, 1.8]
            info['ego2global_rotation'] = [0.7, 0.0, 0.0, 0.71]
            info['ego2global_translation'] = [600.0, 1600.0, 0.0]
    dets = _detections(rng, len(port))
    got = port.format_results(dets, str(tmp_path / 'port'))
    want = jax_ds.format_results(dets, str(tmp_path / 'jax'))
    with open(got) as f, open(want) as g:
        sub = json.load(f)
        assert sub == json.load(g)
    assert set(sub) == {'meta', 'results'}
    m_got = port.evaluate(dets, jsonfile_prefix=str(tmp_path / 'p2'))
    m_want = jax_ds.evaluate(dets)
    assert set(m_got) == set(m_want) >= {'mAP', 'NDS'}
    for k in m_want:
        assert abs(m_got[k] - m_want[k]) <= 1e-6, (k, m_got[k], m_want[k])


def test_native_metrics_equal():
    from msmdfusion_torch.core.evaluation.nuscenes_metrics import \
        evaluate_detections
    from msmdfusion_tpu.core.evaluation.nuscenes_metrics import \
        evaluate_detections as jax_evaluate
    rng = np.random.RandomState(5)
    names = ['car', 'truck', 'barrier', 'traffic_cone', 'pedestrian']
    dets = _detections(rng, 6, n=20)
    gts = []
    for det in dets:           # GT near some detections, plus misses
        g = det['bboxes'][:8] + rng.normal(0, 0.6, (8, 9)).astype(
            np.float32)
        gts.append(dict(bboxes=g, labels=rng.randint(0, 5, 8)))
        det['labels'] = det['labels'] % 5
    got = evaluate_detections(dets, gts, names)
    want = jax_evaluate(dets, gts, names)
    assert set(got) == set(want)
    assert 0 < want['mAP'] < 1
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])


def test_overflow_sites_counted_alike(multimodal_dataset,
                                      monkeypatch):  # noqa: F811
    """PadPoints and PadForeground2D at capacities the samples exceed: the
    same sites, the same dropped rows."""
    from msmdfusion_tpu.utils import overflow as jax_overflow
    _, cfg_path = multimodal_dataset
    pipeline = [dict(t) for t in TEST_PIPELINE]
    pipeline[-3] = dict(type='PadPoints', max_points=400)
    pipeline[-2] = dict(type='PadForeground2D', max_points=20,
                        max_real_points=6)
    port, jax_ds = both(cfg_path, pipeline=pipeline, test_mode=True)
    monkeypatch.setenv('MSMD_OVERFLOW_CHECK', '1')
    jax_overflow.reset()
    with overflow.capture() as cap:
        for i in range(len(port)):
            jax_ds[i]
            port.sample(i)
    want = jax_overflow.counters()
    jax_overflow.reset()
    assert set(want) == {'pipeline.points_cap', 'foreground.points_cap',
                         'foreground.pixels_cap',
                         'foreground.real_pixels_cap'}
    assert cap.counters() == want
