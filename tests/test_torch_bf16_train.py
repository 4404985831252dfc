"""The bf16-compute train step (``compute_dtype='bfloat16'`` with fp32
parameters, the JAX bench's ``MSMD_BF16`` train), port vs the JAX package,
on the CPU.

With fp32 parameters bf16 flows only through the sparse encoder and the
GMA's grouped 3D convs (flax's promotion: a bf16 input meets fp32
parameters in fp32 everywhere else), so the JAX side is held where bf16
flows and the whole flagship's bf16 step runs on the port alone: compiling
the flagship under ``jax.grad`` once more costs the suite minutes, and
everything downstream of the GMA is fp32 and held to ``jax.grad`` by
``test_torch_train_step.py``.

- ``MatchConv``'s backward on bf16 features and a bf16 cotangent against
  the JAX package's ``_pallas_bwd`` in interpret mode, on each engine
  (``MSMD_CONV_*`` set with ``monkeypatch``): the rulebook engine on its
  default x3 product, packed, and one-hot, whose ``d_feats`` runs the
  bf16 conv (``match_conv_bf16``'s plain version) over the dual plan of a
  strided conv. ``d_feats`` bf16 within one bf16 ulp plus 1e-4 of its
  largest value; ``d_w`` fp32 within ``BWD_TOL``.
- Train-mode ``MaskedBatchNorm`` and ``BatchNorm2d`` on bf16 inputs
  against the JAX ``MaskedBatchNorm``: bf16 out, fp32 statistics.
- The sparse encoder and a GMA stage's grouped 3D conv block (its only
  bf16 part: a subm conv, batch norm and ReLU on the stage's LiDAR-only
  rows), in training mode on bf16 voxel features, forward and ``jax.vjp``
  (compiled without XLA's excess precision, as ``test_torch_bf16.py``'s
  ``capture``). The block: its output within one bf16 ulp plus 1e-4 of
  its largest value, its gradients within 2^-7 of theirs, its statistics
  within ``TOL``. The encoder's 21 layers carry bf16 rounding flips on,
  so every tensor of its run is held to 10 times the port's own spread
  under reordered sums (never less than 1e-4 of max), the rule of
  ``chip_smoke.py``'s bf16 phases.
- The tiny flagship's bf16 step through ``make_train_step``, port only,
  on each engine: finite losses, every trainable parameter's gradient
  fp32, the sparse encoder's activations bf16, the parameters fp32 after
  the update.
- Training with parameters cast to bf16 (``cast_params``) raises, naming
  the ROADMAP.
"""
import contextlib
import copy
import dataclasses
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from msmdfusion_tpu.models.layers import MaskedBatchNorm as JaxBatchNorm
from msmdfusion_tpu.models.sparse_blocks import \
    SparseConvBlock as JaxConvBlock
from msmdfusion_tpu.ops.sparse import matchconv as jmc
from msmdfusion_tpu.ops.sparse import tensor as jtensor
from msmdfusion_tpu.registry import MIDDLE_ENCODERS as JAX_ENCODERS

import msmdfusion_torch.models  # noqa: F401
from msmdfusion_torch.apis.train import (FROZEN_IMG_PREFIXES,
                                         build_lr_schedule, build_optimizer,
                                         make_train_step)
from msmdfusion_torch.models.builder import build_detector as port_build
from msmdfusion_torch.models.layers import (BatchNorm2d, MaskedBatchNorm,
                                            cast_params)
from msmdfusion_torch.models.sparse_blocks import SparseConvBlock
from msmdfusion_torch.ops.sparse import matchconv as tmc
from msmdfusion_torch.ops.sparse import tensor as ttensor
from msmdfusion_torch.ops.voxelize import voxelize_mean_batch
from msmdfusion_torch.registry import MIDDLE_ENCODERS
from msmdfusion_torch.utils.convert import from_jax_variables, new_rules
from msmdfusion_torch.utils.convert import msmdfusion_rules
from chip_smoke import FLOOR_MARGIN, ReorderedSums
from tests.test_torch_bf16 import torch_of
from tests.test_torch_msmdfusion import PCR, VOX, make_batch, port_inputs
from tests.test_torch_onehot import rowless_plans
from tests.test_torch_train_ops import BWD_TOL, jax_plan, port_plan, strided
from tests.test_torch_train_step import (TOL, make_gt,
                                         train_config)
from tests.test_torch_transfusion_l import randomize
# the port's CPU ops on one thread (bf16 kernels on many threads stall when
# the suite's other workers hold the cores); imported by other modules too
from tests.torch_threads import one_thread  # noqa: F401

ENGINES = {'x3': {}, 'packed': {'MSMD_CONV_DTYPE': 'bfloat16'},
           'onehot': {'MSMD_CONV_ALGO': 'onehot'}}
SWITCHES = ('MSMD_CONV_ALGO', 'MSMD_CONV_DTYPE', 'MSMD_CONV_GEMM')
BF16 = jnp.bfloat16


@pytest.fixture(params=sorted(ENGINES))
def engine(request, monkeypatch):
    for k in SWITCHES:
        monkeypatch.delenv(k, raising=False)
    for k, v in ENGINES[request.param].items():
        monkeypatch.setenv(k, v)
    return request.param


def ulp(x):
    """One bf16 ulp at each |x| (fp32 tensor or array)."""
    x = np.abs(np.asarray(x, np.float32))
    e = np.frexp(np.maximum(x, np.finfo(np.float32).tiny))[1]
    return np.ldexp(1.0, e - 8).astype(np.float32)


def assert_bf16_close(got, want, what, ulps=1):
    """``got`` (torch bf16) within ``ulps`` bf16 ulps of ``want`` (bf16,
    JAX or torch) plus 1e-4 of its largest value: one per bf16 rounding
    between the inputs the two share and the tensor."""
    assert got.dtype == torch.bfloat16, (what, got.dtype)
    w = (want.float().numpy() if torch.is_tensor(want)
         else np.asarray(jnp.asarray(want).astype(jnp.float32)))
    g = got.detach().float().numpy()
    assert g.shape == w.shape, (what, g.shape, w.shape)
    assert np.abs(w).max() > 0, what
    limit = ulps * ulp(w) + 1e-4 * np.abs(w).max()
    bad = np.abs(g - w) > limit
    assert not bad.any(), (what, int(bad.sum()), g[bad][:4], w[bad][:4])


def test_match_conv_backward_on_bf16_matches_jax(engine):
    """A strided conv: ``d_feats`` runs over its dual plan."""
    rng = np.random.RandomState(11)
    conv = (3, 2, 1)
    j, t, jout, tout = strided(rng, *conv)
    if engine == 'onehot':
        jplan, plan = rowless_plans(j, t, jout, tout, conv)
    else:
        jplan, plan = jax_plan(j, jout, conv), port_plan(t, tout, conv)
        if tmc.needs_order():
            plan = dataclasses.replace(
                tmc.attach_rows(t.keys, plan, order=True, pairs=True),
                dual=tmc.attach_rows(tout[0], plan.dual, order=True))
    ta, cin, cout = plan.num_taps, 8, 12
    w = (rng.randn(ta, cin, cout) * 0.1).astype(np.float32)
    k_pad = jplan.inb.shape[0]
    g = jnp.asarray(rng.randn(k_pad, cout).astype(np.float32)).astype(BF16)
    jfeats = j.features.astype(BF16)

    feats = torch_of(jfeats)[:t.capacity].clone().requires_grad_(True)
    weights = torch.from_numpy(w).requires_grad_(True)
    in_keys = t.keys if engine == 'onehot' else None
    out = tmc.MatchConv.apply(feats, weights, plan, in_keys)
    assert out.dtype == torch.bfloat16
    out.backward(torch_of(g)[:plan.k_out])

    gf, gw = jmc._pallas_bwd(jfeats, j.keys, jplan, jnp.asarray(w), g, 1024,
                             None, interpret=True)
    assert gf.dtype == BF16 and gw.dtype == jnp.float32
    assert_bf16_close(feats.grad, gf[:t.capacity], 'd_feats')
    assert weights.grad.dtype == torch.float32
    np.testing.assert_allclose(weights.grad.numpy(), np.asarray(gw),
                               rtol=BWD_TOL, atol=BWD_TOL)


def test_train_mode_batch_norms_on_bf16_match_jax():
    rng = np.random.RandomState(12)
    x = jnp.asarray(rng.randn(200, 6) * 3 + 1).astype(BF16)
    mask = rng.rand(200) < 0.8
    jbn = JaxBatchNorm(momentum=0.1, eps=1e-3)
    variables = jbn.init(jax.random.PRNGKey(0), x)
    variables = {'params': {'scale': jnp.asarray(rng.uniform(0.5, 1.5, 6),
                                                 jnp.float32),
                            'bias': jnp.asarray(rng.randn(6), jnp.float32)},
                 'batch_stats': variables['batch_stats']}
    for m in (jnp.asarray(mask), None):
        want, stats = jbn.apply(variables, x, mask=m, train=True,
                                mutable=['batch_stats'])
        bn = MaskedBatchNorm(6, eps=1e-3, momentum=0.1)
        bn.weight.data = torch_of(variables['params']['scale'])
        bn.bias.data = torch_of(variables['params']['bias'])
        bn.train()
        got = bn(torch_of(x), mask=None if m is None else torch.from_numpy(
            mask))
        assert_bf16_close(got, want, 'MaskedBatchNorm')
        for ours, theirs in ((bn.running_mean, 'mean'),
                             (bn.running_var, 'var')):
            assert ours.dtype == torch.float32
            np.testing.assert_allclose(
                ours.numpy(), np.asarray(stats['batch_stats'][theirs]),
                rtol=1e-5, atol=1e-6)
    # the dense norm: NCHW, moments over all but the channels
    x4 = x[:32].reshape(2, 4, 4, 6)
    want, stats = jbn.apply(variables, x4, train=True,
                            mutable=['batch_stats'])
    bn2 = BatchNorm2d(6, eps=1e-3, momentum=0.1)
    bn2.weight.data = torch_of(variables['params']['scale'])
    bn2.bias.data = torch_of(variables['params']['bias'])
    bn2.train()
    got = bn2(torch_of(x4).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert_bf16_close(got, want, 'BatchNorm2d')
    np.testing.assert_allclose(bn2.running_mean.numpy(),
                               np.asarray(stats['batch_stats']['mean']),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn2.running_var.numpy(),
                               np.asarray(stats['batch_stats']['var']),
                               rtol=1e-5, atol=1e-6)
    assert int(bn2.num_batches_tracked) == 1


def encoder_rules():
    """The converter's rules of the sparse encoder, under ``enc``."""
    rules = [r for r in msmdfusion_rules(depth=18, layer_nums=(2, 2))
             if r[0].startswith('pts_middle_encoder.')]
    return [('enc.' + t.split('.', 1)[1], 'enc/' + f.split('/', 1)[1], kind,
             ks) for t, f, kind, ks in rules]


def loaded(module, variables, rules):
    """``module`` with the JAX variables through ``rules`` (prefix
    ``enc.``/``blk.`` taken off)."""
    sd = from_jax_variables(variables, rules)
    module.load_state_dict({k.split('.', 1)[1]: v for k, v in sd.items()})
    return module


@pytest.fixture(scope='module')
def stage():
    """The sparse encoder and a grouped conv block on bf16 voxel features
    in training mode: JAX forward + vjp, and the port's."""
    from tests.test_torch_msmdfusion import tiny_config
    rng = np.random.RandomState(13)
    batch = make_batch(rng)
    f, coors, valid = voxelize_mean_batch(
        torch.from_numpy(batch['points']),
        torch.from_numpy(batch['points_mask']), VOX, PCR, 6000)
    enc_cfg = dict(tiny_config()['pts_middle_encoder'])
    jenc = JAX_ENCODERS.build(dict(enc_cfg))
    feats = jnp.asarray(f.numpy()).astype(BF16)
    jc, jv = jnp.asarray(coors.numpy()), jnp.asarray(valid.numpy())

    def run_enc(variables, x):
        (bev, _), mutated = jenc.apply(variables, x, jc, jv, 1, train=True,
                                       assume_sorted=True,
                                       mutable=['batch_stats'])
        return bev, mutated['batch_stats']

    shapes = jax.eval_shape(functools.partial(
        jenc.init, coors=jc, valid=jv, batch_size=1, assume_sorted=True),
        jax.random.PRNGKey(0), feats)
    enc_vars = randomize(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), dict(shapes)), rng)

    # the grouped conv block on a stage's LiDAR-only rows
    c3 = 4
    only = valid.numpy() & (rng.rand(valid.shape[0]) < 0.7)
    x3 = np.where(only[:, None], rng.randn(valid.shape[0], c3), 0)
    x3 = jnp.asarray(x3.astype(np.float32)).astype(BF16)
    # the stage's keys unmasked, its validity the LiDAR-only rows (JAX
    # gma_encoder.py:213-219)
    jst = dataclasses.replace(jtensor.make_sparse_tensor(
        x3, jc, jv, enc_cfg['sparse_shape'], 1, assume_sorted=True),
        valid=jnp.asarray(only))
    jblk = JaxConvBlock(c3, 3, padding=1, conv_type='SubMConv3d',
                        indice_key='subm3D_1', norm_eps=1e-3,
                        norm_momentum=0.01)

    def run_blk(variables, x):
        (out, _), mutated = jblk.apply(
            variables, jst.replace_features(x), {}, train=True,
            mutable=['batch_stats'])
        return out.features, mutated['batch_stats']

    blk_shapes = jax.eval_shape(
        lambda k, x: jblk.init(k, jst.replace_features(x), {}),
        jax.random.PRNGKey(0), x3)
    blk_vars = randomize(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), dict(blk_shapes)), rng)

    def fwd_vjp(run, variables, x, seed):
        def f(p, xx):
            return run({'params': p, 'batch_stats':
                        variables['batch_stats']}, xx)
        (out, new_stats), vjp = jax.vjp(f, variables['params'], x)
        ct = jnp.asarray(np.random.RandomState(seed).randn(*out.shape)
                         .astype(np.float32)).astype(out.dtype)
        grads = vjp((ct, jax.tree_util.tree_map(jnp.zeros_like, new_stats)))
        return out, new_stats, grads, ct

    def jax_side(enc_v, blk_v):
        return (fwd_vjp(run_enc, enc_v, feats, 1),
                fwd_vjp(run_blk, blk_v, x3, 2))

    compiled = jax.jit(jax_side).lower(enc_vars, blk_vars).compile(
        {'xla_allow_excess_precision': False})
    jenc_out, jblk_out = compiled(enc_vars, blk_vars)

    # the port: the encoder also with its sums reordered (the spread its
    # own rounding makes), the block on the stage's LiDAR-only rows
    def port_encoder(*scopes):
        enc = loaded(MIDDLE_ENCODERS.build(dict(enc_cfg)), {
            'params': {'enc': enc_vars['params']},
            'batch_stats': {'enc': enc_vars['batch_stats']}},
            encoder_rules())
        enc.train()
        x = torch_of(feats).requires_grad_(True)
        with contextlib.ExitStack() as stack:
            for scope in scopes:
                stack.enter_context(scope)
            bev, _ = enc(x, coors, valid, 1, assume_sorted=True)
            bev.backward(torch_of(jenc_out[3]).permute(0, 3, 1, 2))
        return run_of(enc, x, bev.permute(0, 2, 3, 1))

    rules, add = new_rules()
    add('blk.0', 'blk/SubMConv3d_0', 'spconv')
    add('blk.1', 'blk/MaskedBatchNorm_0', 'bn')

    def port_block():
        blk = SparseConvBlock(c3, c3, 3, padding=1, conv_type='SubMConv3d',
                              indice_key='subm3D_1')
        loaded(blk, {'params': {'blk': blk_vars['params']},
                     'batch_stats': {'blk': blk_vars['batch_stats']}}, rules)
        blk.train()
        x = torch_of(x3).requires_grad_(True)
        st = dataclasses.replace(ttensor.make_sparse_tensor(
            x, coors, valid, enc_cfg['sparse_shape'], 1,
            assume_sorted=True), valid=torch.from_numpy(only))
        out, _ = blk(st, {})
        out.features.backward(torch_of(jblk_out[3]))
        return run_of(blk, x, out.features)

    return dict(
        enc=(port_encoder(), port_encoder(ReorderedSums()),
             jax_run(jenc_out, encoder_rules(), 'enc')),
        blk=(port_block(), None, jax_run(jblk_out, rules, 'blk')),
        only=torch.from_numpy(only))


def run_of(module, x, out):
    """A port run's output, input gradient, parameter gradients and
    running statistics."""
    return dict(out=out.detach(), x_grad=x.grad,
                grads={n: p.grad for n, p in module.named_parameters()},
                stats={k: v for k, v in module.state_dict().items()
                       if k.endswith(('running_mean', 'running_var'))})


def jax_run(jout, rules, prefix):
    """The JAX run's, as ``run_of``'s, under the port's names."""
    out, new_stats, (pgrads, xgrad), _ = jout
    sd = from_jax_variables({'params': {prefix: pgrads},
                             'batch_stats': {prefix: new_stats}}, rules)
    sd = {k.split('.', 1)[1]: v for k, v in sd.items()}
    stats = {k: v for k, v in sd.items()
             if k.endswith(('running_mean', 'running_var'))}
    return dict(out=torch_of(out), x_grad=torch_of(xgrad),
                grads={k: v for k, v in sd.items() if k not in stats
                       and not k.endswith('num_batches_tracked')},
                stats=stats)


def held(got, want, alt, what):
    """``got`` within FLOOR_MARGIN times the port's own spread under
    reordered sums (``alt``) of ``want``, never less than 1e-4 of its
    largest value. Returns the error over the largest value."""
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    g, w, a = (t.detach().float().numpy() for t in (got, want, alt))
    scale = np.abs(w).max()
    assert scale > 0, what
    err = np.abs(g - w).max() / scale
    spread = np.abs(a - g).max() / scale
    assert err <= max(1e-4, FLOOR_MARGIN * spread), (what, err, spread)
    return err


def test_bf16_encoder_train_matches_jax_within_its_own_spread(stage):
    """The sparse encoder in training mode on bf16 voxel features: output,
    input gradient, every parameter gradient and running statistic. Each
    of its 21 convs rounds its output, and each norm its input gradient,
    to bf16, which turns fp32 sum-order ulps into bf16 steps that the next
    layers and the train-mode norms over a few hundred rows carry on (its
    fp32 twin agrees with JAX to ~1e-6): every tensor is held to the
    port's own spread under reordered sums, as chip_smoke's bf16 phases
    hold theirs."""
    run, alt, ref = stage['enc']
    assert run['out'].dtype == run['x_grad'].dtype == torch.bfloat16
    held(run['out'], ref['out'], alt['out'], 'output')
    held(run['x_grad'], ref['x_grad'], alt['x_grad'], 'input gradient')
    assert set(run['grads']) == set(ref['grads'])
    for name, g in run['grads'].items():
        assert g is not None and g.dtype == torch.float32, name
        held(g, ref['grads'][name], alt['grads'][name], name)
    assert run['stats']
    for name, v in run['stats'].items():
        assert v.dtype == torch.float32, name
        held(v, ref['stats'][name], alt['stats'][name], name)


def test_bf16_grouped_block_train_matches_jax(stage):
    """One bf16 layer: its output within one bf16 ulp plus 1e-4 of max;
    its input gradient, on the rows it reads (the LiDAR-only rows: the GMA
    masks the others' features to 0, so their gradient goes nowhere), and
    its parameter gradients within 2^-7 of max (``test_torch_bf16.py``'s
    two bf16 roundings: the norm's input gradient is rounded to bf16
    before the conv's backward sums it, and the conv's input gradient
    once more); its statistics within ``TOL``."""
    run, _, ref = stage['blk']
    only = stage['only']
    assert_bf16_close(run['out'], ref['out'], 'output')
    got, want = run['x_grad'][only].float(), ref['x_grad'][only].float()
    assert run['x_grad'].dtype == torch.bfloat16
    assert float((got - want).abs().max()) <= 2.0 ** -7 * float(
        want.abs().max())
    for name, g in run['grads'].items():
        assert g.dtype == torch.float32, name
        want = ref['grads'][name].numpy()
        err = float(np.abs(g.numpy() - want).max())
        assert err <= 2.0 ** -7 * float(np.abs(want).max()), (name, err)
    for name, v in run['stats'].items():
        want = ref['stats'][name].numpy()
        np.testing.assert_allclose(v.numpy(), want, rtol=TOL,
                                   atol=TOL * np.abs(want).max(),
                                   err_msg=name)


def bf16_flagship():
    cfg = train_config()
    cfg['compute_dtype'] = 'bfloat16'
    return port_build(copy.deepcopy(cfg), device='cpu', seed=0)


def test_tiny_flagship_bf16_step(engine):
    rng = np.random.RandomState(0)
    batch = make_batch(rng)
    gt = {k: torch.from_numpy(v) for k, v in make_gt(rng).items()}
    port = bf16_flagship()
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    opt = build_optimizer(port, dict(lr=1e-3, weight_decay=0.01),
                          dict(grad_clip=dict(max_norm=10)),
                          build_lr_schedule(dict(policy='step'), 1e-3, 10, 1),
                          frozen_prefixes=FROZEN_IMG_PREFIXES)
    seen = []
    hook = port.pts_middle_encoder.register_forward_hook(
        lambda m, a, o: seen.append([o[0].dtype]
                                    + [s.features.dtype for s in o[1]]))
    try:
        metrics = make_train_step(port, opt)(
            dict(inputs=port_inputs(batch), **gt), 0)
    finally:
        hook.remove()
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert len(seen) == 1 and set(seen[0]) == {torch.bfloat16}
    trained = {id(p) for g in opt.param_groups for p in g['params']}
    for name, p in port.named_parameters():
        assert p.dtype == torch.float32, name
        if id(p) in trained and name.startswith(('pts_middle_encoder.',
                                                 'multimodal_middle_encoder.'
                                                 'grouped_sp_conv_blocks_3D')):
            assert p.grad is not None and p.grad.dtype == torch.float32, name
            assert torch.isfinite(p.grad).all(), name
            assert not torch.equal(p.detach(), before[name]), name
    assert float(metrics['grad_norm']) > 0


def test_training_cast_parameters_raises():
    port = cast_params(bf16_flagship())
    port.train()
    batch = make_batch(np.random.RandomState(0))
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        port(*port_inputs(batch))
    port.eval()
    with torch.no_grad():
        assert torch.isfinite(port(*port_inputs(batch))['heatmap']).all()
