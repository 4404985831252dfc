"""Port MSMDFusion train step vs the JAX package's, on the CPU.

The tiny flagship of ``test_torch_msmdfusion.py`` (ResNet-18, narrow
sparse widths, a 64 x 64 x 41 grid, two cameras, 10 proposals) with its
training settings, dropout 0 and one seed. Seeded random JAX variables go
into the port through ``from_jax_variables``; the JAX side runs its XLA
paths, the port its kernels' plain versions.

- The loss dict and the Hungarian assignment against the JAX model's.
- Every parameter gradient against ``jax.grad``, mapped onto the port's
  names by the same converter (the map is linear, so it carries
  gradients), to ``GRAD_TOL`` of each tensor's largest |value| (see its
  comment for why).
- One full AdamW step (clip 10, warmup, weight decay) from the port's
  ``make_train_step``: parameters and batch-norm statistics against the
  JAX package's ``make_train_step``. Adam's first step moves a parameter
  by about the learning rate whatever its gradient's size, so parameters
  are held to 1e-3 of the learning rate beyond 1e-5 relative, except
  where the gradient is within its tolerance of 0 (its sign unsettled).
- The frozen image branch gets no gradient and keeps its statistics.
- ``realistic_batch(return_gt=True)`` equals the JAX package's.
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
from msmdfusion_tpu.utils.synth_scene import realistic_batch as jax_scene

from msmdfusion_torch.apis.train import (build_lr_schedule, build_optimizer,
                                         make_train_step, total_loss)
from msmdfusion_torch.utils.convert import (from_jax_variables,
                                            msmdfusion_rules)
from msmdfusion_torch.utils.synth_scene import realistic_batch
from tests.test_torch_msmdfusion import (PCR, VOX, build_pair, jax_inputs,
                                         make_batch, port_inputs,
                                         tiny_config)
from tests.torch_threads import one_thread  # noqa: F401

TOL = 1e-4
# the port's own gradients move by up to 3.2e-4 of a tensor's largest
# |value| when its sparse convs sum in another order: train-mode batch
# norms over a few hundred rows and the decoder amplify fp32 rounding
GRAD_TOL = 1e-3
# a bias ahead of a train-mode batch norm has a zero gradient in exact
# arithmetic: every tensor is also allowed GRAD_TOL of NOISE times the
# model's largest gradient
NOISE = 1e-3
FROZEN_JAX = ('backbone_img', 'neck_img')
FROZEN_PORT = ('img_backbone', 'img_neck')
LR_CFG = dict(policy='step', warmup='linear', warmup_iters=10,
              warmup_ratio=0.1, step=[1])
OPT_CFG = dict(type='AdamW', lr=3e-3, weight_decay=0.05)
CLIP_CFG = dict(grad_clip=dict(max_norm=10))


def train_config():
    cfg = tiny_config()
    cfg['pts_bbox_head'] = dict(cfg['pts_bbox_head'], dropout=0.0)
    cfg['train_cfg'] = dict(pts=dict(
        dataset='nuScenes',
        assigner=dict(type='HungarianAssigner3D',
                      cls_cost=dict(gamma=2, alpha=0.25, weight=0.15),
                      reg_cost=dict(weight=0.25),
                      iou_cost=dict(weight=0.25)),
        pos_weight=-1, gaussian_overlap=0.1, min_radius=2,
        grid_size=[64, 64, 40], voxel_size=VOX, out_size_factor=8,
        code_weights=[1.0] * 8 + [0.2, 0.2], point_cloud_range=PCR))
    return cfg


def make_gt(rng, g=6, valid=4):
    """Padded ground truth in the tiny range: bottom-centre boxes with a
    velocity, ``valid`` of ``g`` slots filled."""
    boxes = np.zeros((1, g, 9), np.float32)
    boxes[0, :, :2] = rng.uniform(-1.8, 1.8, (g, 2))
    boxes[0, :, 2] = -1.8
    boxes[0, :, 3:6] = rng.uniform(0.4, 1.6, (g, 3))
    boxes[0, :, 6] = rng.uniform(-np.pi, np.pi, g)
    boxes[0, :, 7:9] = rng.normal(0, 0.5, (g, 2))
    labels = rng.randint(0, 10, (1, g)).astype(np.int32)
    ok = np.zeros((1, g), bool)
    ok[0, :valid] = True
    return dict(gt_bboxes=boxes, gt_labels=labels, gt_valid=ok)


def jax_loss_fn(jmodel, batch_stats, inputs, gt):
    def loss_fn(params):
        variables = {'params': params, 'batch_stats': batch_stats}
        preds, mutated = jmodel.apply(variables, *inputs, train=True,
                                      mutable=['batch_stats'])
        losses = jmodel.apply(variables, preds, gt['gt_bboxes'],
                              gt['gt_labels'], gt['gt_valid'],
                              method=type(jmodel).loss)
        total = sum(v for k, v in losses.items() if 'loss' in k)
        return total, (losses, mutated['batch_stats'], preds)
    return loss_fn


@pytest.fixture(scope='module')
def step():
    """The JAX loss, gradients and one make_train_step update, and the
    port's train-mode forward, loss and backward on the same weights."""
    rng = np.random.RandomState(0)
    batch = make_batch(rng)
    gt = make_gt(rng)
    cfg = train_config()
    jmodel, variables, port = build_pair(
        cfg, batch, msmdfusion_rules(depth=18, layer_nums=(2, 2)))
    rules = msmdfusion_rules(depth=18, layer_nums=(2, 2))
    params, batch_stats = variables['params'], variables['batch_stats']
    schedule = jax_schedule(LR_CFG, OPT_CFG['lr'], 10, 1)
    tx = jax_optimizer(OPT_CFG, CLIP_CFG, schedule, params=params,
                       frozen_predicates=FROZEN_JAX)
    jstep = jax_train_step(jmodel, tx, frozen_predicates=FROZEN_JAX)

    @jax.jit
    def jax_side(params, batch_stats, inputs, jgt):
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
        jax_side(params, batch_stats, jax_inputs(batch),
                 {k: jnp.asarray(v) for k, v in gt.items()})

    # the port: one forward + loss + backward, then (on a copy built from
    # the same weights) one full optimizer step
    port.train()
    tgt = {k: torch.from_numpy(v) for k, v in gt.items()}
    preds = port(*port_inputs(batch))
    targets = port.pts_bbox_head.get_targets(
        preds, tgt['gt_bboxes'], tgt['gt_labels'], tgt['gt_valid'])
    losses = port.loss(preds, tgt['gt_bboxes'], tgt['gt_labels'],
                       tgt['gt_valid'], targets=targets)
    for name, p in port.named_parameters():
        if name.startswith(FROZEN_PORT):
            p.requires_grad_(False)
    total_loss(losses).backward()

    port2 = copy.deepcopy(port)
    port2.load_state_dict(from_jax_variables(variables, rules))
    for p in port2.parameters():
        p.grad = None
    opt = build_optimizer(port2, OPT_CFG, CLIP_CFG,
                          build_lr_schedule(LR_CFG, OPT_CFG['lr'], 10, 1),
                          frozen_prefixes=FROZEN_PORT)
    metrics = make_train_step(port2, opt)(
        dict(inputs=port_inputs(batch), **tgt), 0)
    return dict(
        rules=rules, variables=variables, port=port, port2=port2,
        jtotal=jtotal, jlosses=jlosses, jgrads=jgrads,
        jassign=assign, losses=losses, targets=targets, metrics=metrics,
        jmetrics=jmetrics, new_params=new_params, new_stats=new_stats)


def as_port(tree, variables, rules):
    """A JAX params-shaped tree (values or gradients) under the port's
    parameter names."""
    sd = from_jax_variables({'params': tree,
                             'batch_stats': variables['batch_stats']}, rules)
    return {k: v.numpy() for k, v in sd.items()}


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
                                   float(want),
                                   rtol=TOL, atol=1e-6, err_msg=key)
    np.testing.assert_allclose(float(total_loss(step['losses']).detach()),
                               float(step['jtotal']), rtol=TOL)


def test_gradients_match_jax_grad(step):
    want = as_port(step['jgrads'], step['variables'], step['rules'])
    port = step['port']
    scale = max(float(np.abs(want[n]).max()) for n, p in
                port.named_parameters() if not n.startswith(FROZEN_PORT))
    errs = []
    for name, p in port.named_parameters():
        if name.startswith(FROZEN_PORT):
            assert p.grad is None, name      # no gradient reaches the image
            assert not np.abs(want[name]).any(), name
            continue
        assert p.grad is not None, name
        got, ref = p.grad.numpy(), want[name]
        limit = GRAD_TOL * max(float(np.abs(ref).max()), NOISE * scale)
        errs.append((float(np.abs(got - ref).max()) / limit, name))
    errs.sort(reverse=True)
    assert len(errs) > 100
    assert errs[0][0] <= 1.0, f'error over limit, worst: {errs[:5]}'


def test_one_adamw_step_matches_make_train_step(step):
    port2 = step['port2']
    np.testing.assert_allclose(float(step['metrics']['total_loss']),
                               float(step['jmetrics']['total_loss']),
                               rtol=TOL)
    np.testing.assert_allclose(float(step['metrics']['grad_norm']),
                               float(step['jmetrics']['grad_norm']),
                               rtol=TOL)
    new = from_jax_variables({'params': step['new_params'],
                              'batch_stats': step['new_stats']},
                             step['rules'])
    old = from_jax_variables(step['variables'], step['rules'])
    lr = build_lr_schedule(LR_CFG, OPT_CFG['lr'], 10, 1)(0)
    grads = as_port(step['jgrads'], step['variables'], step['rules'])
    scale = max(float(np.abs(grads[n]).max()) for n, _ in
                port2.named_parameters() if not n.startswith(FROZEN_PORT))
    sd = port2.state_dict()
    moved = 0
    for name, want in new.items():
        if name.endswith('num_batches_tracked'):
            continue
        got = sd[name].numpy()
        if name.startswith(FROZEN_PORT):
            np.testing.assert_array_equal(got, old[name].numpy(), name)
            np.testing.assert_array_equal(want.numpy(), old[name].numpy(),
                                          name)
            continue
        if name.endswith(('running_mean', 'running_var')):
            np.testing.assert_allclose(got, want.numpy(), rtol=TOL,
                                       atol=TOL * np.abs(want.numpy()).max(),
                                       err_msg=name)
            continue
        # Adam's first step moves p by lr * g / (|g| + eps): where |g| is
        # within the gradients' tolerance of 0 its sign is not settled
        g = grads[name]
        unsettled = np.abs(g) <= 10 * GRAD_TOL * max(
            float(np.abs(g).max()), NOISE * scale)
        want = want.numpy()
        atol = np.where(unsettled, 2.01 * lr, 1e-3 * lr)
        bad = np.abs(got - want) > atol + 1e-5 * np.abs(want)
        assert not bad.any(), (name, got[bad][:4], want[bad][:4])
        moved += int(not np.array_equal(got, old[name].numpy()))
    assert moved > 100


def test_realistic_batch_ground_truth_equals_jax():
    shape = dict(n=3000, v=2, m=400, mr=200, img_hw=(64, 96),
                 pcr=[-54.0, -54.0, -5.0, 54.0, 54.0, 3.0])
    want = jax_scene(shape, b=2, seed=5, return_gt=True, max_gt=8)
    got = realistic_batch(shape, b=2, seed=5, return_gt=True, max_gt=8)
    assert set(got['gt']) == set(want['gt'])
    for key, value in want['gt'].items():
        assert got['gt'][key].dtype == value.dtype, key
        np.testing.assert_array_equal(got['gt'][key], value, key)
    assert got['gt']['gt_valid'].sum() > 0
    np.testing.assert_array_equal(got['points'], want['points'])
    np.testing.assert_array_equal(got['img'], want['img'])
