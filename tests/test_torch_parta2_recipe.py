"""Part-A2's training recipe from seed weights, port vs the JAX package, on
the CPU, at the config's widths.

``configs/parta2_kitti.py`` at every width, cut in scale only: the range
to 12.8 x 16 m (grid 41 x 320 x 256), 4,000 points and voxels of
``chip_smoke.kitti_frame``, 16 proposals, and no RoI dropout (the JAX
step's mask cannot be drawn by the port). The weights are the port's seed
weights with the norms calibrated on the frame, as ``chip_smoke.py``
phase 23 trains them, carried into flax variables; the JAX config drops
the U-Net's ``order`` key, which the JAX ``SparseUNet`` lacks.

Two steps of the config's AdamW, clip and cyclic schedule on each side:
the first step's loss and gradient norm agree within ``TOL``, and the
second step's gradient norm is finite on both sides or on neither. Run
with ``-s`` to see each step's numbers and the RoI sizes before and after
the first update.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import msmdfusion_tpu.models  # noqa: F401
from msmdfusion_tpu.apis import train as jtrain
from msmdfusion_tpu.config import load_config as jax_load_config
from msmdfusion_tpu.models.builder import build_detector as jax_build

import chip_smoke
import msmdfusion_torch.models  # noqa: F401
from msmdfusion_torch.apis.train import (build_lr_schedule, build_optimizer,
                                         make_train_step)
from msmdfusion_torch.config import load_config
from msmdfusion_torch.models.builder import build_detector as port_build
from msmdfusion_torch.utils.calibrate import calibrate_norms
from msmdfusion_torch.utils.convert import zoo_rules
from tests.test_torch_zoo_detectors import to_flax
from tests.torch_threads import one_thread  # noqa: F401

CONFIG = 'configs/parta2_kitti.py'
TOL = 1e-4
X, Y = 12.8, 8.0                # the cut range: [0, -Y, -3, X, Y, 1]
POINTS = 4000
PROPOSALS = 16
STEPS = 2


def cut(model_cfg):
    """The config's model with its scale cut as the docstring says."""
    m = model_cfg
    m.pts_voxel_layer.update(point_cloud_range=[0, -Y, -3, X, Y, 1],
                             max_voxels=(POINTS, POINTS))
    m.pts_middle_encoder.sparse_shape = [41, round(2 * Y / 0.05),
                                         round(X / 0.05)]
    for r in m.rpn_head.anchor_generator.ranges:
        r[1], r[3], r[4] = -Y, X, Y
    m.test_cfg.rpn.max_num = PROPOSALS
    m.num_proposals = PROPOSALS
    m.roi_head.dropout_ratio = 0.0
    return m


def sizes(rois):
    s = np.asarray(rois)[0][:, 3:6]
    return float(s.min()), float(s.max())


def port_side(cfg, model, inputs, gt):
    schedule = build_lr_schedule(dict(cfg.lr_config), cfg.optimizer['lr'],
                                 cfg.total_epochs * 1000, 1000)
    opt = build_optimizer(model, dict(cfg.optimizer),
                          dict(cfg.optimizer_config), schedule)
    step = make_train_step(model, opt, seed=0)
    batch = dict(inputs=inputs, gt_bboxes=gt[0], gt_labels=gt[1],
                 gt_valid=gt[2])
    rois, metrics = [], []
    for i in range(STEPS):
        model.train()
        with torch.no_grad():
            rois.append(sizes(model(*inputs)['roi']['rois']))
        out = step(batch, i)
        metrics.append({k: float(out[k]) for k in ('total_loss',
                                                   'grad_norm')})
    return rois, metrics


def jax_side(variables, inputs, gt):
    cfg = jax_load_config(CONFIG)
    model_cfg = cut(cfg.model)
    model_cfg.pts_middle_encoder.pop('order')
    model = jax_build(model_cfg)
    params, stats = variables['params'], variables['batch_stats']
    schedule = jtrain.build_lr_schedule(dict(cfg.lr_config),
                                        cfg.optimizer['lr'],
                                        cfg.total_epochs * 1000, 1000)
    tx = jtrain.build_optimizer(dict(cfg.optimizer),
                                dict(cfg.optimizer_config), schedule,
                                params=params)
    step = jax.jit(jtrain.make_train_step(model, tx))
    jin = tuple(jnp.asarray(x.numpy()) for x in inputs)
    batch = dict(inputs=jin, **{k: jnp.asarray(v.numpy()) for k, v in zip(
        ('gt_bboxes', 'gt_labels', 'gt_valid'), gt)})

    @jax.jit
    def forward(params, stats):
        preds, _ = model.apply({'params': params, 'batch_stats': stats},
                               *jin, train=True, mutable=['batch_stats'])
        return preds['roi']['rois']
    state = tx.init(params)
    rois, metrics = [], []
    for i in range(STEPS):
        rois.append(sizes(forward(params, stats)))
        params, stats, state, out = step(params, stats, state, batch, i)
        metrics.append({k: float(out[k]) for k in ('total_loss',
                                                   'grad_norm')})
    return rois, metrics


@pytest.mark.slow
def test_parta2_recipe_from_seed_weights_matches_jax(one_thread):
    cfg = load_config(CONFIG)
    model = port_build(cut(cfg.model), device='cpu', seed=0)
    inputs, gt = chip_smoke.kitti_frame(model, POINTS, 'cpu')
    with torch.no_grad():
        calibrate_norms(model, *inputs)
    # copies: the port's optimizer updates its tensors in place
    variables = jax.tree_util.tree_map(
        np.array, to_flax(model.state_dict(), zoo_rules(cfg.model)))
    got = port_side(cfg, model, inputs, gt)
    want = jax_side(variables, inputs, gt)
    for side, (rois, metrics) in (('port', got), ('jax', want)):
        for i in range(STEPS):
            print(f'{side} step {i}: RoI sizes {rois[i][0]:.4g} to '
                  f'{rois[i][1]:.4g} m before it, total loss '
                  f'{metrics[i]["total_loss"]:.6g}, gradient norm '
                  f'{metrics[i]["grad_norm"]:.6g}')
    assert got[0][0] == pytest.approx(want[0][0], rel=TOL)
    for key in ('total_loss', 'grad_norm'):
        assert got[1][0][key] == pytest.approx(want[1][0][key], rel=TOL), key
    assert np.isfinite(got[1][-1]['grad_norm']) == \
        np.isfinite(want[1][-1]['grad_norm'])
