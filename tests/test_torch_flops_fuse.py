"""FLOP and parameter counts and the conv-BN fold, port vs the JAX package,
on the CPU.

- ``apis.flops_counter.count_flops``: a sparse conv block's FLOP equal
  2 x hits x Cin x Cout exactly, hits counted on the JAX package's own
  ``build_subm_plan``/``build_downsample_plan`` rows of the same
  coordinates, on the rulebook engine's plain path and on the one-hot
  engine's alike (no dense op of the plain versions counted); a training
  step's backward adds the input gradient's and the weight gradient's
  products; ``masked_nn`` counts 8 x its pairs; dense convs and linears
  their closed forms. A tiny TransFusion-L frame counts the same on both
  engines.
- ``count_params`` equals the JAX ``count_params`` of the tiny
  TransFusion-L's and the tiny flagship's variables (``jax.eval_shape``,
  nothing compiled).
- ``tools.misc.fuse_conv_bn``: the pairs it folds are the pairs the JAX
  ``fuse_tree`` folds (the same state-dict keys change, mapped through
  ``from_jax_variables``), on TransFusion-L and on the flagship's layout
  (SECOND (5, 5), whose pair count ``chip_smoke.FUSED_PAIRS`` holds); the
  folded values are within 1e-6 relative of ``fuse_tree``'s on the pairs
  where the JAX tool is right (its fixed eps 1e-3 is the norm's, and the
  conv has no bias) and differ on the others; on the TransFusion head's
  ``heatmap_conv1`` (eps 1e-5, a conv bias) the port's fused module equals
  the unfused one within 1e-5 of max, and the JAX fold misses it by 5.05e-3
  of max.
"""
import copy
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import msmdfusion_tpu.models  # noqa: F401
from msmdfusion_tpu.apis.flops_counter import count_params as jax_params
from msmdfusion_tpu.config import load_config
from msmdfusion_tpu.models.builder import build_detector as jax_build
from msmdfusion_tpu.ops.sparse import matchconv as jax_mc
from msmdfusion_tpu.ops.sparse.conv import \
    downsample_out_coords as jax_out_coords
from msmdfusion_tpu.ops.sparse.tensor import \
    make_sparse_tensor as jax_sparse_tensor

import msmdfusion_torch.models  # noqa: F401
from msmdfusion_torch.apis.flops_counter import count_flops, count_params
from msmdfusion_torch.config import load_config as port_load_config
from msmdfusion_torch.models.backbones.second import SECOND
from msmdfusion_torch.models.builder import build_detector as port_build
from msmdfusion_torch.models.middle_encoders import gma_encoder
from msmdfusion_torch.models.sparse_blocks import SparseConvBlock
from msmdfusion_torch.ops.sparse.tensor import make_sparse_tensor
from msmdfusion_torch.tools.misc.fuse_conv_bn import (fold_pairs,
                                                      fuse_conv_bn)
from msmdfusion_torch.utils.convert import (from_jax_variables,
                                            msmdfusion_rules)
import chip_smoke
from tests.test_torch_msmdfusion import build_pair, make_batch, tiny_config
from tests.test_torch_transfusion_l import (make_points, randomize,
                                            tiny_model_cfg)

REPO = Path(__file__).resolve().parents[1]
SHAPE = (21, 40, 40)


def fuse_tree():
    spec = importlib.util.spec_from_file_location(
        'jax_fuse_conv_bn', REPO / 'tools' / 'misc' / 'fuse_conv_bn.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.fuse_tree


def coords(rng, n=1500, batch=2):
    """Unique random voxels of ``batch`` samples in a ``SHAPE`` grid."""
    c = np.stack([rng.randint(0, batch, n)] + [rng.randint(0, s, n)
                                                for s in SHAPE], 1)
    return np.unique(c, axis=0).astype(np.int32)


def jax_hits(c, cin, strided):
    """Valid (row, tap) pairs of the JAX package's plan on coordinates
    ``c`` (and its strided output set), in one jitted function."""
    @jax.jit
    def hits(c):
        feats = jnp.zeros((c.shape[0], cin), jnp.float32)
        st = jax_sparse_tensor(feats, c, jnp.ones(c.shape[0], bool), SHAPE,
                               2)
        if strided:
            _, oc, ov, _ = jax_out_coords(st, 3, 2, 1, c.shape[0])
            plan = jax_mc.build_downsample_plan(st, oc, ov, 3, 2, 1)
        else:
            plan = jax_mc.build_subm_plan(st, 3)
        return (jax_mc.plan_rows(st.keys, plan) >= 0).sum()
    return int(hits(jnp.asarray(c)))


def port_tensor(c, feats):
    return make_sparse_tensor(feats, torch.from_numpy(c),
                              torch.ones(len(c), dtype=torch.bool), SHAPE, 2)


@pytest.mark.parametrize('strided', [False, True])
def test_sparse_conv_flops_equal_hits_on_jax_plans(strided, monkeypatch):
    rng = np.random.RandomState(0)
    c = coords(rng)
    cin, cout = 5, 12
    want = 2 * jax_hits(c, cin, strided) * cin * cout
    kind = dict(conv_type='SparseConv3d', stride=2, padding=1,
                out_capacity=len(c)) if strided else {}
    block = SparseConvBlock(cin, cout, 3, indice_key='k', **kind).eval()
    feats = torch.from_numpy(rng.randn(len(c), cin).astype(np.float32))
    for algo in ('vgather', 'onehot'):
        monkeypatch.setenv('MSMD_CONV_ALGO', algo)
        with torch.no_grad():
            got = count_flops(lambda: block(port_tensor(c, feats), {}))
        name = 'match_conv' if algo == 'onehot' else 'gather_gemm_conv'
        assert got['by_op'] == {name: want}, algo
        assert got['flops'] == got['sparse_flops'] == want

    # a training step: the forward, the input gradient over the transpose
    # plan (the same pairs) and the weight gradient, each 2 x hits x Cin x
    # Cout
    monkeypatch.delenv('MSMD_CONV_ALGO')
    block.train()
    x = feats.clone().requires_grad_(True)

    def step():
        out, _ = block(port_tensor(c, x), {})
        out.features.square().sum().backward()
    got = count_flops(step)['by_op']
    assert got['gather_gemm_conv'] == 2 * want and got['conv_dw'] == want


def test_masked_nn_flops():
    rng = np.random.RandomState(1)
    a = torch.from_numpy(rng.randn(300, 3).astype(np.float32))
    b = torch.from_numpy(rng.randn(200, 3).astype(np.float32))
    ab = torch.from_numpy(rng.randint(0, 3, 300).astype(np.int32))
    bb = torch.from_numpy(rng.randint(0, 3, 200).astype(np.int32))
    valid = torch.from_numpy(rng.rand(200) < 0.7)
    pairs = sum(int((ab == g).sum()) * int(((bb == g) & valid).sum())
                for g in range(3))
    # looked up inside the scope, where the model looks it up
    got = count_flops(lambda: gma_encoder.masked_nn(a, ab, b, bb, valid))
    assert got['by_op'] == {'masked_nn': 8 * pairs} and pairs > 0


def test_dense_flops_closed_form():
    backbone = SECOND(in_channels=6, out_channels=[8, 16], layer_nums=[1, 2],
                      layer_strides=[1, 2]).eval()
    x = torch.randn(1, 6, 12, 10)
    with torch.no_grad():
        got = count_flops(backbone, x)
    # 3 x 3 convs, 'same' padding: stage 0 at 12 x 10, stage 1 at 6 x 5
    want = 2 * 9 * (6 * 8 + 8 * 8) * 120 + 2 * 9 * (8 * 16 + 2 * 16 * 16) * 30
    assert got['by_op'] == {'aten.convolution': want}
    assert got['bytes_accessed'] == -1.0 and got['gflops'] == want / 1e9
    lin = torch.nn.Linear(7, 3)
    assert count_flops(lin, torch.randn(4, 7))['flops'] == 2 * 4 * 7 * 3


@pytest.fixture(scope='module')
def tl():
    """The tiny TransFusion-L: seeded JAX variables (from
    ``jax.eval_shape``) and the port model loaded from them."""
    rng = np.random.RandomState(0)
    points, mask = make_points(rng)
    jmodel = jax_build(tiny_model_cfg(load_config))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.asarray(points), jnp.asarray(mask))
    variables = randomize(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), dict(shapes)), rng)
    port = port_build(tiny_model_cfg(port_load_config), device='cpu')
    port.load_state_dict(from_jax_variables(variables))
    return variables, port, points, mask


@pytest.fixture(scope='module')
def flagship():
    """The tiny flagship with SECOND (5, 5), the full-width layout."""
    rules = msmdfusion_rules(depth=18, layer_nums=(5, 5))
    _, variables, port = build_pair(tiny_config(layer_nums=(5, 5)),
                                    make_batch(np.random.RandomState(2)),
                                    rules, seed=2)
    return variables, port, rules


def test_count_params_matches_jax(tl, flagship):
    for variables, port in (tl[:2], flagship[:2]):
        assert count_params(port) == jax_params(variables['params'])
    # the GMA's dummy embeddings are parameters on both sides
    names = [n for n, _ in flagship[1].named_parameters()
             if 'dummy_embedding' in n]
    assert len(names) == 4


def test_tl_frame_counts_the_same_on_both_engines(tl, monkeypatch):
    _, port, points, mask = tl
    args = (torch.from_numpy(points), torch.from_numpy(mask))
    with torch.no_grad():
        rows = count_flops(port, *args)
        monkeypatch.setenv('MSMD_CONV_ALGO', 'onehot')
        onehot = count_flops(port, *args)
    assert rows['flops'] == onehot['flops'] > rows['sparse_flops'] > 0
    assert rows['by_op']['gather_gemm_conv'] == onehot['by_op']['match_conv']


def folds(variables, port, rules=None):
    """(JAX-folded state dict, its pair count, the port-folded model, its
    pairs, the unfused state dict)."""
    params = jax.tree_util.tree_map(np.array, variables['params'])
    stats = jax.tree_util.tree_map(np.array, variables['batch_stats'])
    n_jax = fuse_tree()(params, stats)
    jax_sd = from_jax_variables(dict(params=params, batch_stats=stats),
                                rules)
    model = copy.deepcopy(port)
    pairs = fold_pairs(model)
    assert fuse_conv_bn(model) == len(pairs)
    return jax_sd, n_jax, model, pairs, port.state_dict()


def pair_keys(pairs):
    return {f'{name}.{p}' for conv, _, bn, _ in pairs
            for name, ps in ((conv, ('weight', 'bias')),
                             (bn, ('weight', 'bias', 'running_mean',
                                   'running_var'))) for p in ps}


def changed(sd, ref):
    return {k for k, v in sd.items() if not torch.equal(v, ref[k])}


def test_fold_pairs_are_jax_fuse_trees(tl, flagship):
    for args in (tl[:2], flagship):
        jax_sd, n_jax, model, pairs, ref = folds(*args)
        assert len(pairs) == n_jax
        keys = pair_keys(pairs)
        got, want = changed(model.state_dict(), ref), changed(jax_sd, ref)
        assert want <= keys and got <= keys
        # the JAX tool leaves the conv biases, the port scales them
        assert want == got - {k for k in got if k.endswith('.bias') and
                              k.rsplit('.', 1)[0] in {c for c, *_ in pairs}}
    assert len(fold_pairs(flagship[1])) == chip_smoke.FUSED_PAIRS


def test_folded_values_match_fuse_tree_where_jax_is_right(tl):
    variables, port, _, _ = tl
    jax_sd, _, model, pairs, _ = folds(variables, port)
    sd = model.state_dict()
    right = [(c, b) for c, conv, b, bn in pairs
             if bn.eps == 1e-3 and conv.bias is None]
    wrong = [(c, b) for c, conv, b, bn in pairs if (c, b) not in right]
    assert len(right) == 26 and [c for c, _ in wrong] == [
        'pts_bbox_head.heatmap_head.0.conv',
        'pts_bbox_head.decoder.0.self_posembed.position_embedding_head.0',
        'pts_bbox_head.decoder.0.cross_posembed.position_embedding_head.0']
    for conv, bn in right:
        for key in (f'{conv}.weight', f'{bn}.weight', f'{bn}.bias',
                    f'{bn}.running_mean', f'{bn}.running_var'):
            want = jax_sd[key].numpy()
            np.testing.assert_allclose(
                sd[key].numpy(), want, rtol=1e-6,
                atol=1e-6 * np.abs(want).max(), err_msg=key)
    for conv, _ in wrong:
        want, got = jax_sd[f'{conv}.weight'], sd[f'{conv}.weight']
        assert float((got - want).abs().max()) > 1e-5 * float(
            want.abs().max()), conv


def test_heatmap_conv1_fold(tl):
    """The port's fold keeps ``heatmap_conv1``'s output; the JAX tool's
    (eps 1e-3 where the norm's is 1e-5, the conv bias unscaled) moves it
    by 5.05e-3 of its largest value on these weights, 505 times the limit
    the port's fold is held to."""
    variables, port, _, _ = tl
    jax_sd, _, model, _, _ = folds(variables, port)
    name = 'pts_bbox_head.heatmap_head.0'
    unfused = port.get_submodule(name)
    fused = model.get_submodule(name)
    jax_fused = copy.deepcopy(unfused)
    jax_fused.load_state_dict({k[len(name) + 1:]: v for k, v in
                               jax_sd.items() if k.startswith(name + '.')})
    assert unfused.bn.eps == 1e-5 and unfused.conv.bias is not None
    x = torch.from_numpy(np.random.RandomState(4).randn(
        1, unfused.conv.in_channels, 16, 16).astype(np.float32))
    with torch.no_grad():
        want, got, jax_got = unfused(x), fused(x), jax_fused(x)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale
    miss = float((jax_got - want).abs().max()) / scale
    assert miss == pytest.approx(5.05e-3, rel=0.01)
