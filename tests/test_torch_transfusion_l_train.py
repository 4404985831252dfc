"""TransFusion-L's stage-1 train step, port vs the JAX package, on the CPU.

The tiny TransFusion-L of ``test_torch_transfusion_l.py`` (SECOND cut to
one block a stage) with its config's training settings
(``configs/transfusion_nusc_voxel_L.py``: the train-time voxel capacity
``max_voxels[0]``, here below the frame's voxel count so that it drops
voxels; AdamW, weight decay 0.01, global-norm clip 0.1, the cyclic
schedule), dropout 0 and one seed. Seeded random JAX
variables go into the port through ``from_jax_variables``; the JAX side
runs its XLA paths, the port its kernels' plain versions.

- ``build_lr_schedule(policy='cyclic')`` against the JAX schedule, with
  and without the linear warmup, at 0, at the ramp's end, at mid-cosine
  and at the last step, to 1e-7 relative.
- The train-time capacity: the training forward drops the voxels past
  ``max_voxels[0]`` and counts them; eval mode keeps them all.
- The losses and the Hungarian assignment against the JAX model's, and
  every parameter gradient against ``jax.grad`` (``test_torch_train_step``'s
  ``TOL`` and ``GRAD_TOL``).
- One ``ClippedAdamW`` step from ``make_train_step`` against the JAX
  package's ``make_train_step``: parameters and batch-norm statistics.
"""
import copy

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import msmdfusion_tpu.models  # noqa: F401
from msmdfusion_tpu.apis.train import build_lr_schedule as jax_schedule
from msmdfusion_tpu.apis.train import build_optimizer as jax_optimizer
from msmdfusion_tpu.apis.train import make_train_step as jax_train_step
from msmdfusion_tpu.config import load_config
from msmdfusion_tpu.models.builder import build_detector as jax_build

import msmdfusion_torch.models  # noqa: F401
from msmdfusion_torch.apis.train import (build_lr_schedule, build_optimizer,
                                         make_train_step, total_loss)
from msmdfusion_torch.config import load_config as port_load_config
from msmdfusion_torch.models.builder import build_detector as port_build
from msmdfusion_torch.utils import overflow
from msmdfusion_torch.utils.convert import (from_jax_variables,
                                            transfusion_l_rules)
from tests.test_torch_train_step import (GRAD_TOL, NOISE, TOL, as_port,
                                         jax_loss_fn, make_gt)
from tests.test_torch_bf16_train import one_thread  # noqa: F401
from tests.test_torch_transfusion_l import (PCR, make_points, randomize,
                                            tiny_model_cfg)

CONFIG = 'configs/transfusion_nusc_voxel_L.py'
TRAIN_CAP = 3000            # the train-time voxel capacity, below the frame's
TOTAL, PER_EPOCH = 100, 5   # schedule steps: the ramp is the first 40
LAYER_NUMS = (1, 1)         # SECOND's depth, cut to keep the JAX compile short
RULES = transfusion_l_rules(LAYER_NUMS)


def train_model_cfg(load):
    cfg = tiny_model_cfg(load)
    cap = cfg.pts_voxel_layer.max_voxels[1]
    cfg.pts_voxel_layer.update(max_voxels=(TRAIN_CAP, cap))
    cfg.pts_backbone.update(layer_nums=list(LAYER_NUMS))
    cfg.pts_bbox_head.update(dropout=0.0)
    cfg.train_cfg.pts.update(grid_size=[64, 64, 40], point_cloud_range=PCR)
    return cfg


def recipe():
    """The config's (optimizer, optimizer_config, lr_config)."""
    cfg = port_load_config(CONFIG)
    return (dict(cfg.optimizer), dict(cfg.optimizer_config),
            dict(cfg.lr_config))


@pytest.mark.parametrize('warmup', [False, True])
def test_cyclic_schedule_matches_jax(warmup):
    _, _, lr_cfg = recipe()
    assert lr_cfg['policy'] == 'cyclic'
    if warmup:
        lr_cfg = dict(lr_cfg, warmup='linear', warmup_iters=10,
                      warmup_ratio=1.0 / 3)
    base = recipe()[0]['lr']
    got = build_lr_schedule(lr_cfg, base, TOTAL, PER_EPOCH)
    want = jax_schedule(lr_cfg, base, TOTAL, PER_EPOCH)
    up = int(TOTAL * lr_cfg['step_ratio_up'])
    steps = [0, 5, up - 1, up, up + (TOTAL - up) // 2, TOTAL - 1, TOTAL + 3]
    for step in steps:
        ref = float(want(jnp.asarray(step, jnp.int32)))
        np.testing.assert_allclose(got(step), ref, rtol=1e-7, err_msg=step)
    # the ramp peaks at target_ratio[0] x base, the cosine ends at
    # target_ratio[1] of the peak
    peak = base * lr_cfg['target_ratio'][0]
    np.testing.assert_allclose(got(up), peak, rtol=1e-6)
    np.testing.assert_allclose(got(TOTAL), peak * lr_cfg['target_ratio'][1],
                               rtol=1e-5)
    assert got(0) < got(up - 1) < got(up) and got(up + 1) < got(up)


@pytest.fixture(scope='module')
def step():
    """The JAX loss, gradients and one make_train_step update, and the
    port's train-mode forward, loss and backward on the same weights."""
    rng = np.random.RandomState(0)
    points, mask = make_points(rng)
    gt = make_gt(rng)
    jmodel = jax_build(train_model_cfg(load_config))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.asarray(points), jnp.asarray(mask))
    variables = randomize(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), dict(shapes)), rng)
    params, batch_stats = variables['params'], variables['batch_stats']
    opt_cfg, clip_cfg, lr_cfg = recipe()
    schedule = jax_schedule(lr_cfg, opt_cfg['lr'], TOTAL, PER_EPOCH)
    tx = jax_optimizer(opt_cfg, clip_cfg, schedule, params=params)
    jstep = jax_train_step(jmodel, tx)
    inputs = (jnp.asarray(points), jnp.asarray(mask))

    @jax.jit
    def jax_side(params, batch_stats, jgt):
        """One compile for the gradients, the targets and the update."""
        (total, (losses, _, preds)), grads = jax.value_and_grad(
            jax_loss_fn(jmodel, batch_stats, inputs, jgt),
            has_aux=True)(params)
        assign = jmodel.apply(
            {'params': params, 'batch_stats': batch_stats}, preds,
            jgt['gt_bboxes'], jgt['gt_labels'], jgt['gt_valid'],
            method=lambda m, *a: m.bbox_head.get_targets(*a))
        new = jstep(params, batch_stats, tx.init(params),
                    {'inputs': inputs, **jgt}, 0)
        return total, losses, grads, assign, new

    jtotal, jlosses, jgrads, assign, (new_params, new_stats, _, jmetrics) = \
        jax_side(params, batch_stats,
                 {k: jnp.asarray(v) for k, v in gt.items()})

    port = port_build(train_model_cfg(port_load_config), device='cpu')
    port.load_state_dict(from_jax_variables(variables, RULES))
    port2 = copy.deepcopy(port)
    port.train()
    tgt = {k: torch.from_numpy(v) for k, v in gt.items()}
    pts, msk = torch.from_numpy(points), torch.from_numpy(mask)
    with overflow.capture() as cap:
        preds = port(pts, msk)
    dropped = cap.counters()
    targets = port.pts_bbox_head.get_targets(
        preds, tgt['gt_bboxes'], tgt['gt_labels'], tgt['gt_valid'])
    losses = port.loss(preds, tgt['gt_bboxes'], tgt['gt_labels'],
                       tgt['gt_valid'], targets=targets)
    total_loss(losses).backward()

    opt = build_optimizer(port2, opt_cfg, clip_cfg, build_lr_schedule(
        lr_cfg, opt_cfg['lr'], TOTAL, PER_EPOCH))
    metrics = make_train_step(port2, opt)(dict(inputs=(pts, msk), **tgt), 0)
    return dict(
        variables=variables, port=port, port2=port2, points=pts, mask=msk,
        dropped=dropped, jtotal=jtotal, jlosses=jlosses, jgrads=jgrads,
        jassign=assign, losses=losses, targets=targets, metrics=metrics,
        jmetrics=jmetrics, new_params=new_params, new_stats=new_stats,
        lr=build_lr_schedule(lr_cfg, opt_cfg['lr'], TOTAL, PER_EPOCH)(0))


def test_training_takes_the_train_time_capacity(step):
    port = copy.deepcopy(step['port2'])
    vl = port.pts_voxel_layer
    with torch.no_grad(), overflow.capture() as cap:
        port.eval()
        port(step['points'], step['mask'])
    assert cap.total() == 0, cap.counters()
    n_voxels = max(cap.gauge_values()['occ.voxelize_mean'])
    assert n_voxels > TRAIN_CAP == vl['max_voxels'][0] < vl['max_voxels'][1]
    dropped = {k: v for k, v in step['dropped'].items() if v}
    assert dropped == {'voxelize.mean_batch.voxel_cap': n_voxels - TRAIN_CAP}


def test_losses_and_assignment_match_jax(step):
    labels, _, bbox_targets, bbox_weights, num_pos, ious, heatmap = \
        step['targets']
    jlabels, _, jtargets, jweights, jnum, jious, jheatmap = step['jassign']
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))
    np.testing.assert_array_equal(bbox_weights.numpy(), np.asarray(jweights))
    assert int(num_pos) == int(jnum) and int(num_pos) > 0
    np.testing.assert_allclose(bbox_targets.numpy(), np.asarray(jtargets),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(heatmap.numpy(), np.asarray(jheatmap),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(ious), float(jious), rtol=1e-5,
                               atol=1e-6)
    assert set(step['losses']) == set(step['jlosses'])
    for key, want in step['jlosses'].items():
        np.testing.assert_allclose(float(step['losses'][key].detach()),
                                   float(want), rtol=TOL, atol=1e-6,
                                   err_msg=key)
    np.testing.assert_allclose(float(total_loss(step['losses']).detach()),
                               float(step['jtotal']), rtol=TOL)


def test_gradients_match_jax_grad(step):
    want = as_port(step['jgrads'], step['variables'], RULES)
    named = dict(step['port'].named_parameters())
    assert set(named) == set(want) - {k for k in want if 'running' in k
                                      or 'num_batches' in k}
    scale = max(float(np.abs(want[n]).max()) for n in named)
    errs = []
    for name, p in named.items():
        assert p.grad is not None, name
        ref = want[name]
        limit = GRAD_TOL * max(float(np.abs(ref).max()), NOISE * scale)
        errs.append((float(np.abs(p.grad.numpy() - ref).max()) / limit,
                     name))
    errs.sort(reverse=True)
    assert len(errs) > 50
    assert errs[0][0] <= 1.0, f'error over limit, worst: {errs[:5]}'


def test_one_adamw_step_matches_make_train_step(step):
    port2 = step['port2']
    for key in ('total_loss', 'grad_norm'):
        np.testing.assert_allclose(float(step['metrics'][key]),
                                   float(step['jmetrics'][key]), rtol=TOL,
                                   err_msg=key)
    new = from_jax_variables({'params': step['new_params'],
                              'batch_stats': step['new_stats']}, RULES)
    old = from_jax_variables(step['variables'], RULES)
    grads = as_port(step['jgrads'], step['variables'], RULES)
    names = dict(port2.named_parameters())
    scale = max(float(np.abs(grads[n]).max()) for n in names)
    lr = step['lr']
    sd = port2.state_dict()
    moved = 0
    for name, want in new.items():
        if name.endswith('num_batches_tracked'):
            continue
        got, want = sd[name].numpy(), want.numpy()
        if name.endswith(('running_mean', 'running_var')):
            np.testing.assert_allclose(got, want, rtol=TOL,
                                       atol=TOL * np.abs(want).max(),
                                       err_msg=name)
            assert not np.array_equal(got, old[name].numpy()), name
            continue
        # Adam's first step moves p by lr * g / (|g| + eps): where |g| is
        # within the gradients' tolerance of 0 its sign is not settled
        g = grads[name]
        unsettled = np.abs(g) <= 10 * GRAD_TOL * max(
            float(np.abs(g).max()), NOISE * scale)
        atol = np.where(unsettled, 2.01 * lr, 1e-3 * lr)
        bad = np.abs(got - want) > atol + 1e-5 * np.abs(want)
        assert not bad.any(), (name, got[bad][:4], want[bad][:4])
        moved += int(not np.array_equal(got, old[name].numpy()))
    assert moved == len(names)
