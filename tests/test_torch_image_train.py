"""Training the image branch (``freeze_img=False``), port vs the JAX
package on the CPU.

The tiny flagship's train step of ``test_torch_train_step.py`` with the
image branch trained. The JAX package then masks nothing in the optimizer
(``apis/train.py::freeze_mask`` over no predicates: ``frozen_stages`` is
read nowhere, ``resnet.py:6-8``) and its ResNet keeps every batch norm on
its running statistics (``norm_eval``, ``resnet.py:100-104``).

- Every image-branch parameter's gradient (ResNet-18 and FPN, the stem
  and the first stage included) against ``jax.grad``, to
  ``test_torch_train_step.py``'s tolerance;
- the ResNet's batch-norm statistics unchanged by a train-mode forward
  and an AdamW step, as the JAX package's are;
- the parameters the port's optimizer updates are exactly those the optax
  mask trains: all of them.
"""
import copy

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from msmdfusion_tpu.apis.train import freeze_mask

from msmdfusion_torch.apis.train import (build_lr_schedule, build_optimizer,
                                         make_train_step, total_loss)
from msmdfusion_torch.utils.convert import msmdfusion_rules
from tests.test_torch_msmdfusion import (build_pair, jax_inputs, make_batch,
                                         port_inputs)
from tests.test_torch_train_step import (CLIP_CFG, GRAD_TOL, LR_CFG, NOISE,
                                         OPT_CFG, as_port, jax_loss_fn,
                                         make_gt, train_config)
from tests.torch_threads import one_thread  # noqa: F401

IMAGE = ('img_backbone.', 'img_neck.')


@pytest.fixture(scope='module')
def image_step():
    rng = np.random.RandomState(0)
    batch = make_batch(rng)
    gt = make_gt(rng)
    cfg = dict(train_config(), freeze_img=False)
    rules = msmdfusion_rules(depth=18, layer_nums=(2, 2))
    jmodel, variables, port = build_pair(cfg, batch, rules)
    params, stats = variables['params'], variables['batch_stats']

    @jax.jit
    def jax_side(params, inputs, jgt):
        (_, (_, new_stats, _)), grads = jax.value_and_grad(
            jax_loss_fn(jmodel, stats, inputs, jgt), has_aux=True)(params)
        return grads, new_stats
    jgrads, jstats = jax_side(params, jax_inputs(batch),
                              {k: jnp.asarray(v) for k, v in gt.items()})

    tgt = {k: torch.from_numpy(v) for k, v in gt.items()}
    before = {k: v.clone() for k, v in port.state_dict().items()}
    port.train()
    preds = port(*port_inputs(batch))
    total_loss(port.loss(preds, tgt['gt_bboxes'], tgt['gt_labels'],
                         tgt['gt_valid'])).backward()
    grads = {n: p.grad for n, p in port.named_parameters()}
    after_forward = {k: v.clone() for k, v in port.state_dict().items()}

    port2 = copy.deepcopy(port)
    port2.load_state_dict(before)
    opt = build_optimizer(port2, OPT_CFG, CLIP_CFG,
                          build_lr_schedule(LR_CFG, OPT_CFG['lr'], 10, 1))
    make_train_step(port2, opt)(dict(inputs=port_inputs(batch), **tgt), 0)
    return dict(rules=rules, variables=variables, jgrads=jgrads,
                jstats=jstats, grads=grads, before=before,
                after_forward=after_forward, port2=port2, opt=opt)


def test_image_gradients_match_jax_grad(image_step):
    want = as_port(image_step['jgrads'], image_step['variables'],
                   image_step['rules'])
    grads = image_step['grads']
    scale = max(float(np.abs(v).max()) for v in want.values()
                if v.dtype != np.int64)
    errs = []
    for name, g in grads.items():
        if not name.startswith(IMAGE):
            continue
        ref = want[name]
        if g is None:               # an FPN level the detector never reads
            assert not np.abs(ref).any(), name
            continue
        limit = GRAD_TOL * max(float(np.abs(ref).max()), NOISE * scale)
        errs.append((float(np.abs(g.numpy() - ref).max()) / limit, name))
    errs.sort(reverse=True)
    names = {n for _, n in errs}
    assert 'img_backbone.conv1.weight' in names            # the stem
    assert any(n.startswith('img_backbone.layer1.') for n in names)
    assert any(n.startswith('img_neck.') for n in names)
    assert len(errs) > 60
    assert float(np.abs(grads['img_backbone.conv1.weight'].numpy()).max()) \
        > 0
    assert errs[0][0] <= 1.0, f'error over limit, worst: {errs[:5]}'


def test_norm_eval_keeps_the_image_statistics(image_step):
    before = image_step['before']
    sd2 = image_step['port2'].state_dict()
    stats = [k for k in before if k.startswith('img_backbone.')
             and k.endswith(('running_mean', 'running_var'))]
    assert len(stats) > 20
    for key in stats:
        assert torch.equal(image_step['after_forward'][key], before[key]), key
        assert torch.equal(sd2[key], before[key]), key
    # as the JAX package's: its train-mode forward returns them unchanged
    jstats = image_step['jstats']['backbone_img']
    for leaf, old in zip(jax.tree_util.tree_leaves(jstats),
                         jax.tree_util.tree_leaves(
                             image_step['variables']['batch_stats']
                             ['backbone_img'])):
        np.testing.assert_array_equal(np.asarray(leaf), np.asarray(old))
    # the other norms do take the batch's moments
    moved = [k for k in before if k.endswith('running_mean')
             and not k.startswith(IMAGE) and not torch.equal(sd2[k],
                                                             before[k])]
    assert moved


def test_trained_parameters_are_the_optax_masks(image_step):
    variables = image_step['variables']
    labels = freeze_mask(variables['params'], ())
    trained = jax.tree_util.tree_map(
        lambda label, p: np.full(np.shape(p), label == 'trainable',
                                 np.float32),
        labels, variables['params'])
    mask = as_port(trained, variables, image_step['rules'])
    port2 = image_step['port2']
    in_opt = {id(p) for g in image_step['opt'].param_groups
              for p in g['params']}
    names = dict(port2.named_parameters())
    for name, p in names.items():
        want = bool(mask[name].all())
        assert bool(mask[name].any()) == want, name
        assert (id(p) in in_opt) == want, name
        assert p.requires_grad == want, name
    assert all(bool(mask[n].all()) for n in names if n.startswith(IMAGE))
