"""The flagship's train step split over 2 gloo ranks vs the single-process
step on the whole batch, and the head's loss split over 2 ranks vs the
JAX head's loss on the whole batch, on the CPU.

- The tiny flagship of ``tests/test_torch_train_step.py`` (its training
  settings, its AdamW recipe) with the head's dropout at 0.1, weights from
  one seed, a batch of two frames: each of 2 ranks steps on one frame
  (``make_train_step`` inside the group: global batch-norm moments, global
  loss normalisers, gradients summed over the ranks, the global batch's
  dropout masks) against the port's single-process step on both frames,
  to that file's limits: the loss terms and ``grad_norm`` to ``TOL``
  relative, every gradient to ``GRAD_TOL`` of its tensor's largest value
  (``NOISE`` of the model's largest allowed), the running statistics to
  ``TOL``, the parameters after the step to 1e-3 of the learning rate
  beyond 1e-5 relative where the gradient's sign is settled. The two
  ranks end with the same bits in every tensor; no row is dropped.
- ``TransFusionHead.loss`` on each rank's sample of seeded predictions
  and ground truth (the head of ``tests/test_torch_targets.py``), with
  and without TransFusion-LC's ``on_the_image``: the ranks' terms sum to
  the JAX head's loss on both samples, to 1e-5.
"""
import copy

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from msmdfusion_tpu.models.heads.transfusion_head import \
    TransFusionHead as JaxHead
from tests.test_torch_msmdfusion import make_batch
from tests.test_torch_targets import HEAD, PCR, random_boxes
from tests.test_torch_train_step import (CLIP_CFG, FROZEN_PORT, GRAD_TOL,
                                         LR_CFG, NOISE, OPT_CFG, TOL,
                                         make_gt, train_config)
from tests.torch_ranks import (ddp_step_rank, flagship_step, head_loss_rank,
                               ranks_running)

RECIPE = dict(optimizer=OPT_CFG, clip=CLIP_CFG, lr=LR_CFG,
              frozen=FROZEN_PORT)


def two_frames(seed=0):
    rng = np.random.RandomState(seed)
    frames = [make_batch(rng) for _ in range(2)]
    gts = [make_gt(rng) for _ in range(2)]
    batch = {k: np.concatenate([f[k] for f in frames])
             for k in ('points', 'points_mask', 'img')}
    batch['fg'] = {k: np.concatenate([f['fg'][k] for f in frames])
                   for k in frames[0]['fg']}
    gt = {k: np.concatenate([g[k] for g in gts]) for k in gts[0]}
    return batch, gt


@pytest.fixture(scope='module')
def steps():
    """The single-process step (on one torch thread, as each rank runs:
    on all cores it stalls while the suite's other workers hold them),
    computed while the 2 ranks run theirs."""
    cfg = train_config()
    cfg['pts_bbox_head'] = dict(cfg['pts_bbox_head'], dropout=0.1)
    batch, gt = two_frames()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with ranks_running(ddp_step_rank, 2, cfg, batch, gt,
                           RECIPE) as ranks:
            single = flagship_step(copy.deepcopy(cfg), batch, gt, RECIPE)
    finally:
        torch.set_num_threads(threads)
    return single, ranks


def test_ranks_end_with_the_same_bits(steps):
    single, ranks = steps
    a, b = ranks
    assert a['metrics'] == b['metrics']
    for key, value in a['state'].items():
        np.testing.assert_array_equal(value, b['state'][key], key)
    for rec in (single, *ranks):
        assert not any(rec['overflow'].values()), rec['overflow']


def test_split_losses_and_gradients_match_the_whole_batch(steps):
    single, (got, _) = steps
    want = single['metrics']
    assert set(got['metrics']) == set(want)
    for key, value in want.items():
        np.testing.assert_allclose(got['metrics'][key], value, rtol=TOL,
                                   atol=1e-6, err_msg=key)
    grads = single['grads']
    assert set(got['grads']) == set(grads)
    scale = max(float(np.abs(g).max()) for n, g in grads.items()
                if not n.startswith(FROZEN_PORT))
    errs = []
    for name, ref in grads.items():
        limit = GRAD_TOL * max(float(np.abs(ref).max()), NOISE * scale)
        errs.append((float(np.abs(got['grads'][name] - ref).max()) / limit,
                     name))
    errs.sort(reverse=True)
    assert len(errs) > 100
    assert errs[0][0] <= 1.0, f'error over limit, worst: {errs[:5]}'


def test_split_update_matches_the_whole_batch(steps):
    single, (got, _) = steps
    lr = OPT_CFG['lr'] * LR_CFG['warmup_ratio']     # the step-0 rate
    grads = single['grads']
    scale = max(float(np.abs(g).max()) for n, g in grads.items()
                if not n.startswith(FROZEN_PORT))
    for name, want in single['state'].items():
        value = got['state'][name]
        if name.endswith('num_batches_tracked'):
            np.testing.assert_array_equal(value, want, name)
        elif name.endswith(('running_mean', 'running_var')):
            np.testing.assert_allclose(value, want, rtol=TOL,
                                       atol=TOL * np.abs(want).max(),
                                       err_msg=name)
        elif name in grads:
            g = grads[name]
            unsettled = np.abs(g) <= 10 * GRAD_TOL * max(
                float(np.abs(g).max()), NOISE * scale)
            atol = np.where(unsettled, 2.01 * lr, 1e-3 * lr)
            bad = np.abs(value - want) > atol + 1e-5 * np.abs(want)
            assert not bad.any(), (name, value[bad][:4], want[bad][:4])
        else:
            np.testing.assert_array_equal(value, want, name)


def head_inputs(rng, b=2, g=8):
    p = HEAD['num_proposals']
    gt = np.stack([random_boxes(rng, g, 40.0) for _ in range(b)])
    valid = rng.rand(b, g) < 0.8
    labels = rng.randint(0, 10, (b, g)).astype(np.int32)
    near = gt[:, rng.randint(0, g, p)]
    cell = 8 * 0.6
    hw = HEAD['test_cfg']['grid_size'][0] // 8
    preds = dict(
        heatmap=rng.normal(-2, 1, (b, 10, p)),
        center=((near[..., :2] + rng.normal(0, 0.5, (b, p, 2)) - PCR[0])
                / cell).transpose(0, 2, 1),
        height=(near[..., 2:3] + near[..., 5:6] / 2).transpose(0, 2, 1),
        dim=np.log(near[..., 3:6] * rng.uniform(0.8, 1.2, (b, p, 3)))
        .transpose(0, 2, 1),
        rot=np.stack([np.sin(near[..., 6]), np.cos(near[..., 6])], 1),
        vel=near[..., 7:9].transpose(0, 2, 1),
        dense_heatmap=rng.normal(-2, 1, (b, 10, hw, hw)))
    preds = {k: v.astype(np.float32) for k, v in preds.items()}
    return preds, gt, labels, valid


@pytest.fixture(scope='module')
def head_losses():
    """For TransFusion-L's and TransFusion-LC's (``on_the_image``) cases:
    the JAX head's loss on both samples and each of 2 ranks' terms."""
    rng = np.random.RandomState(3)
    cases = []
    for on_the_image in (False, True):
        preds, gt, labels, valid = head_inputs(rng)
        if on_the_image:
            preds['on_the_image'] = rng.rand(2, HEAD['num_proposals']) < 0.7
        cases.append((preds, gt, labels, valid))
    with ranks_running(head_loss_rank, 2, HEAD, cases) as ranks:
        want = [JaxHead(**HEAD).apply(
            {}, {k: jnp.asarray(v) for k, v in preds.items()},
            jnp.asarray(gt), jnp.asarray(labels), jnp.asarray(valid),
            method=JaxHead.loss) for preds, gt, labels, valid in cases]
    return want, ranks


@pytest.mark.parametrize('case', [0, 1], ids=['lidar', 'on_the_image'])
def test_split_head_loss_matches_jax_on_the_whole_batch(head_losses, case):
    wants, ranks = head_losses
    want, shares = wants[case], [r[case] for r in ranks]
    assert set(shares[0]) == set(want)
    for key, value in want.items():
        np.testing.assert_allclose(shares[0][key] + shares[1][key],
                                   float(value), rtol=1e-5, atol=1e-6,
                                   err_msg=key)
    # each rank holds a share, not the whole (both samples have positives)
    assert 0 < shares[0]['layer_-1_loss_bbox'] < float(
        want['layer_-1_loss_bbox'])
