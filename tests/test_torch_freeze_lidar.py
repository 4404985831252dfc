"""The stage-2 recipe's ``freeze_lidar_components``, port vs the JAX
package, on the CPU.

JAX ``tools/train.py:36,110-118`` freezes the parameters whose path holds
``voxel_encoder`` or ``middle_encoder`` (optax ``set_to_zero`` under
``multi_transform``) and ``make_train_step`` keeps those subtrees' batch
statistics (``_keep_frozen_stats``). The port's ``frozen_prefixes`` maps
the predicates onto its module names (``FROZEN_LIDAR_PREFIXES``).

- On the flagship's names (the converter's tables, no model compiled):
  exactly the parameters that JAX's predicates label frozen fall under
  the port's prefixes, none of ``multimodal_middle_encoder``'s.
- On a small module tree with the flagship's names (voxel encoder,
  middle encoder, multimodal middle encoder and head, each a dense layer
  and a batch norm) and its flax twin, one step of the port's
  ``make_train_step`` against the JAX package's: the frozen parameters
  stay out of the optimizer and do not move; their norms take the batch's
  moments (the output matches JAX's train-mode forward) while their
  running statistics come out bit-equal; the other statistics move as
  JAX's do; the clip's norm counts the trainable gradients only (the
  clip is active, and the parameters match JAX's update) while
  ``grad_norm`` counts all of them, the frozen encoders' included.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from flax import linen as fnn

from msmdfusion_tpu.apis.train import build_lr_schedule as jax_schedule
from msmdfusion_tpu.apis.train import build_optimizer as jax_optimizer
from msmdfusion_tpu.apis.train import freeze_mask
from msmdfusion_tpu.apis.train import make_train_step as jax_train_step
from msmdfusion_tpu.models.layers import MaskedBatchNorm as JaxBatchNorm

from msmdfusion_torch.apis.train import (FROZEN_IMG_PREFIXES,
                                         FROZEN_LIDAR_PREFIXES,
                                         build_lr_schedule, build_optimizer,
                                         frozen_prefixes, global_norm,
                                         make_train_step)
from msmdfusion_torch.config import load_config
from msmdfusion_torch.models.layers import Linear, MaskedBatchNorm
from msmdfusion_torch.utils.convert import msmdfusion_rules
from tests.test_torch_train_step import GRAD_TOL, NOISE, TOL

# JAX tools/train.py:36
JAX_PREDICATES = ('voxel_encoder', 'middle_encoder')
LR_CFG = dict(policy='step', warmup='linear', warmup_iters=10,
              warmup_ratio=0.1, step=[1])
OPT_CFG = dict(type='AdamW', lr=1e-2, weight_decay=0.05)
CLIP = 0.5
NAMES = (('voxel_encoder', 'pts_voxel_encoder'),
         ('middle_encoder', 'pts_middle_encoder'),
         ('mm_encoder', 'multimodal_middle_encoder'),
         ('bbox_head', 'pts_bbox_head'))
WIDTHS = (4, 8, 8, 8, 3)


def test_the_config_freezes_the_lidar_encoders_and_the_image_branch():
    cfg = load_config('configs/MSMDFusion_nusc_voxel_LC.py')
    assert frozen_prefixes(cfg) == FROZEN_LIDAR_PREFIXES + FROZEN_IMG_PREFIXES
    cfg.freeze_lidar_components = False
    assert frozen_prefixes(cfg) == FROZEN_IMG_PREFIXES


def test_prefixes_freeze_what_the_jax_predicates_freeze():
    rules = msmdfusion_rules(depth=18, layer_nums=(2, 2))
    frozen = set()
    for torch_prefix, flax_path, _, _ in rules:
        jax_frozen = any(p in flax_path for p in JAX_PREDICATES)
        port_frozen = any(torch_prefix == f or torch_prefix.startswith(f + '.')
                          for f in FROZEN_LIDAR_PREFIXES)
        assert jax_frozen == port_frozen, (torch_prefix, flax_path)
        if port_frozen:
            frozen.add(torch_prefix.split('.')[0])
    assert frozen == {'pts_middle_encoder'}
    assert any(t.startswith('multimodal_middle_encoder.') for t, *_ in rules)


class JaxBlock(fnn.Module):
    features: int

    @fnn.compact
    def __call__(self, x, train: bool = False):
        x = fnn.Dense(self.features)(x)
        return jax.nn.relu(JaxBatchNorm(momentum=0.1, eps=1e-3)(
            x, train=train))


class JaxTree(fnn.Module):
    """The flax twin: the flagship's JAX module names."""

    def setup(self):
        self.voxel_encoder = JaxBlock(WIDTHS[1])
        self.middle_encoder = JaxBlock(WIDTHS[2])
        self.mm_encoder = JaxBlock(WIDTHS[3])
        self.bbox_head = fnn.Dense(WIDTHS[4])

    def __call__(self, x, train: bool = False):
        h = self.middle_encoder(self.voxel_encoder(x, train), train)
        return {'out': self.bbox_head(self.mm_encoder(h, train))}

    def loss(self, preds, gt_bboxes, gt_labels, gt_valid):
        del gt_labels, gt_valid
        err = preds['out'] - gt_bboxes
        return {'loss_l2': (err ** 2).mean(), 'loss_l1': jnp.abs(err).mean()}


class Block(torch.nn.Sequential):
    def __init__(self, cin, cout):
        super().__init__(Linear(cin, cout),
                         MaskedBatchNorm(cout, eps=1e-3, momentum=0.1))

    def forward(self, x):
        return torch.relu(self[1](self[0](x)))


class Tree(torch.nn.Module):
    """The port's twin, with the flagship's module names."""

    def __init__(self):
        super().__init__()
        self.pts_voxel_encoder = Block(*WIDTHS[0:2])
        self.pts_middle_encoder = Block(*WIDTHS[1:3])
        self.multimodal_middle_encoder = Block(*WIDTHS[2:4])
        self.pts_bbox_head = Linear(*WIDTHS[3:5])

    def forward(self, x, generator=None):
        del generator
        h = self.pts_middle_encoder(self.pts_voxel_encoder(x))
        return {'out': self.pts_bbox_head(self.multimodal_middle_encoder(h))}

    def loss(self, preds, gt_bboxes, gt_labels, gt_valid):
        del gt_labels, gt_valid
        err = preds['out'] - gt_bboxes
        return {'loss_l2': (err ** 2).mean(), 'loss_l1': err.abs().mean()}


def port_state(variables):
    """The flax twin's variables as the port twin's state dict."""
    sd = {}
    for jname, tname in NAMES:
        p = variables['params'][jname]
        if jname == 'bbox_head':
            sd[f'{tname}.weight'] = p['kernel'].T
            sd[f'{tname}.bias'] = p['bias']
            continue
        s = variables['batch_stats'][jname]['MaskedBatchNorm_0']
        sd[f'{tname}.0.weight'] = p['Dense_0']['kernel'].T
        sd[f'{tname}.0.bias'] = p['Dense_0']['bias']
        sd[f'{tname}.1.weight'] = p['MaskedBatchNorm_0']['scale']
        sd[f'{tname}.1.bias'] = p['MaskedBatchNorm_0']['bias']
        sd[f'{tname}.1.running_mean'] = s['mean']
        sd[f'{tname}.1.running_var'] = s['var']
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in
            sd.items()}


@pytest.fixture(scope='module')
def step():
    rng = np.random.RandomState(3)
    x = rng.randn(64, WIDTHS[0]).astype(np.float32) * 2 + 0.5
    gt = rng.randn(64, WIDTHS[4]).astype(np.float32)
    jmodel = JaxTree()
    variables = jax.tree_util.tree_map(np.asarray, dict(jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(x))))
    for node in variables['batch_stats'].values():
        stats = node['MaskedBatchNorm_0']
        stats['mean'] = rng.randn(*stats['mean'].shape).astype(np.float32)
        stats['var'] = rng.uniform(0.5, 2, stats['var'].shape).astype(
            np.float32)
    params = variables['params']
    tx = jax_optimizer(OPT_CFG, dict(grad_clip=dict(max_norm=CLIP)),
                       jax_schedule(LR_CFG, OPT_CFG['lr'], 10, 1),
                       params=params, frozen_predicates=JAX_PREDICATES)
    jstep = jax.jit(jax_train_step(jmodel, tx,
                                   frozen_predicates=JAX_PREDICATES))
    jbatch = dict(inputs=(jnp.asarray(x),), gt_bboxes=jnp.asarray(gt),
                  gt_labels=None, gt_valid=None)
    new_params, new_stats, _, jmetrics = jstep(
        params, variables['batch_stats'], tx.init(params), jbatch, 0)
    jout = jmodel.apply(variables, jnp.asarray(x), train=True,
                        mutable=['batch_stats'])[0]['out']
    jgrads = jax.grad(lambda p: sum(jmodel.apply(
        {'params': p, 'batch_stats': variables['batch_stats']},
        jmodel.apply({'params': p, 'batch_stats': variables['batch_stats']},
                     jnp.asarray(x), train=True, mutable=['batch_stats'])[0],
        jnp.asarray(gt), None, None, method=JaxTree.loss).values()))(params)

    tree = Tree()
    tree.load_state_dict(port_state(variables))
    before = {k: v.clone() for k, v in tree.state_dict().items()}
    opt = build_optimizer(tree, OPT_CFG, dict(grad_clip=dict(max_norm=CLIP)),
                          build_lr_schedule(LR_CFG, OPT_CFG['lr'], 10, 1),
                          frozen_prefixes=FROZEN_LIDAR_PREFIXES)
    tree.train()
    with torch.no_grad():
        out = tree(torch.from_numpy(x))['out']
    tree.load_state_dict(before)
    batch = dict(inputs=(torch.from_numpy(x),),
                 gt_bboxes=torch.from_numpy(gt), gt_labels=None,
                 gt_valid=None)
    metrics = make_train_step(tree, opt)(batch, 0)
    return dict(variables=variables, tree=tree, opt=opt, before=before,
                out=out, jout=jout, metrics=metrics, jmetrics=jmetrics,
                jgrads=jgrads, new=port_state(
                    {'params': new_params, 'batch_stats': new_stats}))


def test_frozen_parameters_are_the_jax_freeze_mask(step):
    labels = freeze_mask(step['variables']['params'], JAX_PREDICATES)
    ones = jax.tree_util.tree_map(
        lambda label, p: np.full(np.shape(p), label == 'frozen',
                                 np.float32),
        labels, step['variables']['params'])
    mask = port_state({'params': ones,
                       'batch_stats': step['variables']['batch_stats']})
    in_opt = {id(p) for g in step['opt'].param_groups for p in g['params']}
    for name, p in step['tree'].named_parameters():
        frozen = bool(mask[name].all())
        assert bool(mask[name].any()) == frozen, name
        assert (id(p) not in in_opt) == frozen, name
        assert p.requires_grad and p.grad is not None, name
        assert frozen == name.startswith(FROZEN_LIDAR_PREFIXES), name
    assert not any(id(p) not in in_opt for n, p in step['tree']
                   .named_parameters()
                   if n.startswith('multimodal_middle_encoder.'))


def test_frozen_norms_take_batch_moments_but_keep_their_statistics(step):
    np.testing.assert_allclose(step['out'].numpy(), np.asarray(step['jout']),
                               rtol=TOL, atol=TOL)
    sd, before = step['tree'].state_dict(), step['before']
    moved = 0
    for name, value in sd.items():
        if not name.endswith(('running_mean', 'running_var')):
            continue
        if name.startswith(FROZEN_LIDAR_PREFIXES):
            assert torch.equal(value, before[name]), name
            assert torch.equal(step['new'][name], before[name]), name
        else:
            assert not torch.equal(value, before[name]), name
            np.testing.assert_allclose(value.numpy(),
                                       step['new'][name].numpy(), rtol=TOL,
                                       atol=1e-6, err_msg=name)
            moved += 1
    assert moved == 2           # the multimodal encoder's mean and var


def test_clip_counts_trainable_gradients_and_grad_norm_counts_all(step):
    tree, opt = step['tree'], step['opt']
    trainable = float(opt.grad_norm())
    everything = float(global_norm(p.grad for p in tree.parameters()))
    assert CLIP < trainable < everything
    np.testing.assert_allclose(float(step['metrics']['grad_norm']),
                               everything, rtol=1e-6)
    np.testing.assert_allclose(float(step['metrics']['grad_norm']),
                               float(step['jmetrics']['grad_norm']), rtol=TOL)
    jgrads = port_state({'params': step['jgrads'],
                         'batch_stats': step['variables']['batch_stats']})
    scale = max(float(g.abs().max()) for g in jgrads.values())
    for name, p in tree.named_parameters():
        # a bias ahead of a train-mode batch norm: 0 in exact arithmetic
        limit = GRAD_TOL * max(float(jgrads[name].abs().max()),
                               NOISE * scale)
        np.testing.assert_allclose(p.grad.numpy(), jgrads[name].numpy(),
                                   rtol=0, atol=limit, err_msg=name)
    # the update: the frozen parameters unchanged, the others as JAX's
    # (Adam's first step on the clipped gradients)
    lr = build_lr_schedule(LR_CFG, OPT_CFG['lr'], 10, 1)(0)
    for name, p in tree.named_parameters():
        old, want = step['before'][name], step['new'][name]
        if name.startswith(FROZEN_LIDAR_PREFIXES):
            assert torch.equal(p.detach(), old), name
            assert torch.equal(want, old), name
            continue
        # Adam's first step moves p by lr * g / (|g| + eps): where |g| is
        # within the gradients' tolerance of 0 its sign is not settled
        g = jgrads[name].numpy()
        unsettled = np.abs(g) <= 10 * GRAD_TOL * max(float(np.abs(g).max()),
                                                     NOISE * scale)
        atol = np.where(unsettled, 2.01 * lr, 1e-3 * lr)
        got = p.detach().numpy()
        assert not np.array_equal(got, old.numpy()), name
        bad = np.abs(got - want.numpy()) > atol + 1e-5 * np.abs(want.numpy())
        assert not bad.any(), (name, got[bad][:4], want.numpy()[bad][:4])
