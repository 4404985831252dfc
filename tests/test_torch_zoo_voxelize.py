"""The zoo's voxelizers, segment reduce and voxel encoders, port vs the
JAX package, on the CPU.

- ``hard_voxelize``, ``voxelize_batch``, ``dynamic_voxelize``,
  ``dynamic_scatter`` (mean and max) and ``scatter_v2`` on clustered points
  (many points a voxel), with masked and out-of-range points and caps that
  overflow: every output equal (the means to 1e-6 relative: the port sums
  in point order as the JAX package's scatter-add on the CPU does), and
  each overflow count equal to JAX's.
- ``PillarFeatureNet``, ``HardVFE``, ``DynamicVFE``, ``PointPillarsScatter``
  and the ``conv_module`` ``SparseEncoder`` (``sparse_shape`` (21, 32, 32),
  widths 4/8) on the same seeded weights (the converter's rules), in eval
  and train mode, within ``TOL`` of the largest value; the train-mode
  running statistics of every norm too: the PFN layers' and the sparse
  encoder's masked norms keep the unbiased variance, ``HardVFE``'s and
  ``DynamicVFE``'s flax ``BatchNorm`` the biased one.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from msmdfusion_tpu.models.middle_encoders.pillar_scatter import \
    PointPillarsScatter as JaxScatter
from msmdfusion_tpu.models.middle_encoders.sparse_encoder import \
    SparseEncoder as JaxSparseEncoder
from msmdfusion_tpu.models.voxel_encoders import voxel_encoder as jenc
from msmdfusion_tpu.ops import scatter as jscatter
from msmdfusion_tpu.ops import voxelize as jvox
from msmdfusion_tpu.utils import overflow as joverflow

from msmdfusion_torch.models.middle_encoders.pillar_scatter import \
    PointPillarsScatter
from msmdfusion_torch.models.middle_encoders.sparse_encoder import \
    SparseEncoder
from msmdfusion_torch.models.voxel_encoders import voxel_encoder as tenc
from msmdfusion_torch.ops import scatter as tscatter
from msmdfusion_torch.ops import voxelize as tvox
from msmdfusion_torch.utils import overflow
from msmdfusion_torch.utils.convert import (from_jax_variables, new_rules,
                                            sparse_encoder_rules,
                                            voxel_encoder_rules)
from tests.test_torch_transfusion_l import randomize

TOL = 1e-5
PCR = [0.0, -3.2, -3.0, 6.4, 3.2, 1.0]
VOX = [0.2, 0.2, 0.2]
PILLAR = [0.2, 0.2, 4.0]
GRID = tvox.grid_shape(VOX, PCR)                        # (20, 32, 32)


def cloud(rng, n=600, centres=40):
    """Points around a few centres (several a voxel), 5 features, some
    outside the range, a mask dropping a tenth."""
    c = rng.uniform(np.array(PCR[:3]), np.array(PCR[3:]), (centres, 3))
    xyz = c[rng.randint(0, centres, n)] + rng.normal(0, 0.08, (n, 3))
    xyz[: n // 20] += 10.0                                  # out of range
    pts = np.concatenate([xyz, rng.rand(n, 2)], 1).astype(np.float32)
    return pts, rng.rand(n) > 0.1


def jax_counts(fn, *args):
    @jax.jit
    def run(*a):
        with joverflow.capture() as cap:
            out = fn(*a)
        return out, cap.counters()
    out, counts = run(*args)
    return out, {k: int(v) for k, v in counts.items()}


def port_counts(fn, *args):
    with overflow.capture() as cap:
        out = fn(*args)
    return out, cap.counters()


def assert_same(got, want, exact=True):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    if exact or got.dtype == bool or np.issubdtype(got.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('max_points,max_voxels', [(4, 300), (3, 60),
                                                   (64, 1000)])
def test_hard_voxelize_matches_jax(max_points, max_voxels):
    pts, mask = cloud(np.random.RandomState(max_voxels))
    want, jc = jax_counts(lambda p, m: jvox.hard_voxelize(
        p, m, VOX, PCR, max_points, max_voxels), jnp.asarray(pts),
        jnp.asarray(mask))
    got, tc = port_counts(tvox.hard_voxelize, torch.from_numpy(pts),
                          torch.from_numpy(mask), VOX, PCR, max_points,
                          max_voxels)
    for g, w in zip(got, want):
        assert_same(g, w)
    assert tc == jc
    if max_voxels == 60:                    # both caps overflow here
        assert tc['voxelize.hard.voxel_cap'] > 0
        assert tc['voxelize.hard.point_truncation'] > 0


def test_voxelize_batch_matches_jax():
    rng = np.random.RandomState(1)
    (p0, m0), (p1, m1) = cloud(rng), cloud(rng)
    pts, mask = np.stack([p0, p1]), np.stack([m0, m1])
    want = jax.jit(lambda p, m: jvox.voxelize_batch(
        p, m, VOX, PCR, 3, 80))(jnp.asarray(pts), jnp.asarray(mask))
    got, tc = port_counts(tvox.voxelize_batch, torch.from_numpy(pts),
                          torch.from_numpy(mask), VOX, PCR, 3, 80)
    for g, w in zip(got, want):
        assert_same(g, w)
    counts = [jax_counts(lambda p, m: jvox.hard_voxelize(
        p, m, VOX, PCR, 3, 80), jnp.asarray(p), jnp.asarray(m))[1]
        for p, m in zip(pts, mask)]
    assert tc == {k: sum(c[k] for c in counts) for k in counts[0]}


@pytest.mark.parametrize('mode,max_voxels', [('mean', 400), ('mean', 50),
                                             ('max', 400), ('max', 50)])
def test_dynamic_voxelize_and_scatter_match_jax(mode, max_voxels):
    pts, mask = cloud(np.random.RandomState(7))
    jcoords, jvalid = jvox.dynamic_voxelize(jnp.asarray(pts),
                                            jnp.asarray(mask), VOX, PCR)
    coords, valid = tvox.dynamic_voxelize(torch.from_numpy(pts),
                                          torch.from_numpy(mask), VOX, PCR)
    assert_same(coords, jcoords)
    assert_same(valid, jvalid)
    feats = pts * np.float32(7.0) - 3.0
    want, jc = jax_counts(lambda f, c, v: jvox.dynamic_scatter(
        f, c, v, GRID, max_voxels, mode), jnp.asarray(feats), jcoords, jvalid)
    got, tc = port_counts(tvox.dynamic_scatter, torch.from_numpy(feats),
                          coords, valid, GRID, max_voxels, mode)
    assert_same(got[0], want[0], exact=(mode == 'max'))
    for g, w in zip(got[1:], want[1:]):
        assert_same(g, w)
    assert tc == jc
    assert (tc['voxelize.dynamic_scatter.voxel_cap'] > 0) == \
        (max_voxels == 50)


@pytest.mark.parametrize('mode', ['max', 'mean', 'sum'])
def test_scatter_v2_matches_jax(mode):
    rng = np.random.RandomState(3)
    feats = rng.randn(500, 6).astype(np.float32)
    ids = rng.randint(-2, 45, 500).astype(np.int32)     # some out of range
    valid = rng.rand(500) > 0.2
    want = jscatter.scatter_v2(jnp.asarray(feats), jnp.asarray(ids), 40,
                               mode, jnp.asarray(valid))
    got = tscatter.scatter_v2(torch.from_numpy(feats), torch.from_numpy(ids),
                              40, mode, torch.from_numpy(valid))
    assert_same(got[0], want[0], exact=(mode == 'max'))
    assert_same(got[1], want[1])


def close(got, want, tol=TOL):
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, err


def load(module, variables, rules):
    module.load_state_dict(from_jax_variables(variables, rules))
    return module


def jax_variables(module, rng, *args):
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    return randomize(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), dict(shapes)), rng)


def jax_apply(module, variables, train, *args, **kw):
    out, mut = jax.jit(lambda v, *a: module.apply(
        v, *a, train=train, mutable=['batch_stats'], **kw))(variables, *args)
    return out, mut.get('batch_stats', {})


def check_stats(port, mutated, rules, before=None):
    """The port's running statistics after a train call against the JAX
    ``batch_stats``; with ``before`` (the state the call began from) each
    as its step from there: a running variance that took the unbiased
    batch variance where flax's ``BatchNorm`` takes the biased one steps
    ~1/rows too far, well inside a tolerance on the statistics
    themselves."""
    sd = from_jax_variables({'params': jax.tree_util.tree_map(
        np.asarray, dict(port['params'])), 'batch_stats': mutated}, rules)
    mine = port['module'].state_dict()
    keys = [k for k in sd if k.endswith(('running_mean', 'running_var'))]
    assert any(k.endswith('running_var') for k in keys), sorted(sd)
    for k in keys:
        if before is None:
            close(mine[k], sd[k].numpy(), 1e-5)
        else:
            close(mine[k] - before[k], sd[k].numpy() - before[k].numpy(),
                  1e-5)


def state(module):
    return {k: v.clone() for k, v in module.state_dict().items()}


def pillar_inputs(rng, f=5):
    pts, mask = cloud(rng, 800)
    res = tvox.voxelize_batch(torch.from_numpy(pts)[None],
                              torch.from_numpy(mask)[None], PILLAR, PCR, 12,
                              120)
    return res


ENCODERS = {
    'PillarFeatureNet': dict(type='PillarFeatureNet', in_channels=5,
                             feat_channels=[8, 16], with_distance=True,
                             voxel_size=PILLAR, point_cloud_range=PCR),
    'HardVFE': dict(type='HardVFE', in_channels=5, feat_channels=[8, 16],
                    with_distance=True, voxel_size=PILLAR,
                    point_cloud_range=PCR),
}


@pytest.mark.parametrize('train', [False, True])
@pytest.mark.parametrize('name', sorted(ENCODERS))
def test_hard_voxel_encoders_match_jax(name, train):
    rng = np.random.RandomState(11)
    voxels, num_points, coors, valid = pillar_inputs(rng)
    cfg = dict(ENCODERS[name])
    kind = cfg.pop('type')
    jmod = getattr(jenc, kind)(**cfg)
    args = tuple(jnp.asarray(x.numpy()) for x in (voxels, num_points, coors))
    variables = jax_variables(jmod, rng, *args)
    rules, add = new_rules()
    voxel_encoder_rules(add, ENCODERS[name], t='', f='')
    rules = [(t[1:], f[1:], k, ks) for t, f, k, ks in rules]
    port = load(getattr(tenc, kind)(**cfg), variables, rules)
    port.train(train)
    want, mutated = jax_apply(jmod, variables, train, *args)
    before = state(port)
    got = port(voxels, num_points, coors)
    close(got, want)
    if train:
        check_stats(dict(module=port, params=variables['params']), mutated,
                    rules, before)


@pytest.mark.parametrize('train', [False, True])
def test_dynamic_vfe_matches_jax(train):
    rng = np.random.RandomState(12)
    pts, mask = cloud(rng, 700)
    coords, valid = tvox.dynamic_voxelize(torch.from_numpy(pts),
                                          torch.from_numpy(mask), VOX, PCR)
    cfg = dict(in_channels=5, feat_channels=[8, 16], with_distance=True,
               voxel_size=VOX, point_cloud_range=PCR)
    jmod = jenc.DynamicVFE(**cfg)
    args = (jnp.asarray(pts), jnp.asarray(coords.numpy()),
            jnp.asarray(valid.numpy()))
    shapes = jax.eval_shape(lambda *a: jmod.init(jax.random.PRNGKey(0), *a,
                                                 max_voxels=300), *args)
    variables = randomize(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), dict(shapes)), rng)
    rules, add = new_rules()
    voxel_encoder_rules(add, dict(cfg, type='DynamicVFE'), t='', f='')
    rules = [(t[1:], f[1:], k, ks) for t, f, k, ks in rules]
    port = load(tenc.DynamicVFE(**cfg), variables, rules).train(train)
    want, mutated = jax.jit(lambda v, *a: jmod.apply(
        v, *a, max_voxels=300, train=train, mutable=['batch_stats']))(
        variables, *args)
    before = state(port)
    got = port(torch.from_numpy(pts), coords, valid, 300)
    close(got[0], want[0])
    assert_same(got[1], want[1])
    assert_same(got[2], want[2])
    if train:
        check_stats(dict(module=port, params=variables['params']),
                    mutated['batch_stats'], rules, before)


def test_pillar_scatter_matches_jax():
    rng = np.random.RandomState(13)
    _, _, coors, valid = pillar_inputs(rng)
    feats = rng.randn(coors.shape[0], 6).astype(np.float32)
    want = JaxScatter(6, (32, 32)).apply(
        {}, jnp.asarray(feats), jnp.asarray(coors.numpy()),
        jnp.asarray(valid.numpy()), 1)
    got = PointPillarsScatter(6, (32, 32))(torch.from_numpy(feats), coors,
                                           valid, 1)
    assert_same(got.permute(0, 2, 3, 1), want)


CONV_MODULE = dict(in_channels=5, sparse_shape=(21, 32, 32),
                   base_channels=4, output_channels=8,
                   encoder_channels=((4,), (8, 8, 8), (8, 8, 8)),
                   encoder_paddings=((1,), (1, 1, 1), (1, 1, 1)),
                   block_type='conv_module')


@pytest.mark.parametrize('train', [False, True])
def test_conv_module_sparse_encoder_matches_jax(train):
    rng = np.random.RandomState(14)
    pts, mask = cloud(rng, 900)
    feats, coors, valid = tvox.voxelize_mean_batch(
        torch.from_numpy(pts)[None], torch.from_numpy(mask)[None], VOX, PCR,
        400)
    jmod = JaxSparseEncoder(**CONV_MODULE)
    args = tuple(jnp.asarray(x.numpy()) for x in (feats, coors, valid))
    shapes = jax.eval_shape(lambda *a: jmod.init(
        jax.random.PRNGKey(0), *a, 1, assume_sorted=True), *args)
    variables = randomize(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), dict(shapes)), rng)
    rules, add = new_rules()
    sparse_encoder_rules(add, CONV_MODULE['encoder_channels'], 'conv_module',
                         t='', f='')
    rules = [(t[1:], f[1:], k, ks) for t, f, k, ks in rules]
    port = load(SparseEncoder(**CONV_MODULE), variables, rules).train(train)
    (want, _), mutated = jax.jit(lambda v, *a: jmod.apply(
        v, *a, 1, train=train, assume_sorted=True,
        mutable=['batch_stats']))(variables, *args)
    got, _ = port(feats, coors, valid, 1, assume_sorted=True)
    close(got.permute(0, 2, 3, 1), want, 1e-5)
    if train:
        check_stats(dict(module=port, params=variables['params']),
                    mutated['batch_stats'], rules)
