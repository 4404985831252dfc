"""The fp32 rulebook engine's ``x3`` route (``MSMD_CONV_GEMM``) vs the JAX
package on the CPU.

On the card the fp32 rulebook engine multiplies on the bf16 tensor cores
by default: both operands split into bf16 hi + lo (``split_hi_lo``), three
products with fp32 sums, lo.lo dropped (the JAX package's default
``gemm_mode()``, ``x3``); ``MSMD_CONV_GEMM=highest`` takes the exact fp32
product. A CPU tensor takes the exact product either way, as the JAX
package's CPU fallback does; the plain versions compute the x3 product on
request (``gemm='x3'``), which ``chip_smoke.py`` holds the x3 kernels to.

What the JAX side computes here: ``_vgather_kernel`` in Pallas interpret
mode on the CPU splits inside the kernel body, and XLA's excess-precision
folding (the ``_split_hi_lo`` docstring's warning) does not turn its lo
parts into zeros there: its conv and backward lie ~1e-7 of each sum's
magnitude from the x3 product and ~6e-6 from the exact one. So the x3
plain versions are held to it at 2^-20 of each sum's magnitude (fp32 sums
in another order), and the exact plain version is checked to lie farther
(the comparison tells the two products apart).

- ``gemm_mode()`` reads ``MSMD_CONV_GEMM`` as the JAX package does (``x3``
  by default, ``highest``), and other values raise;
- ``split_hi_lo`` is bit-equal to the JAX package's ``_split_hi_lo``;
- the x3 plain conv against ``_vgather_conv(..., interpret=True)``, with
  and without the epilogue; ``d_feats`` and ``dw`` against
  ``_pallas_bwd(..., interpret=True)`` on strided plans;
- the x3 plain versions lie within 2^-15 of each sum's magnitude of the
  exact ones;
- the sparse conv layers build each plan's ``RowOrder`` wherever the x3
  (or packed) kernels read it, with the pair lists in training and for
  the dual without; under ``highest`` and one-hot none;
- the wrappers pick each route's kernel (checked with the card's kernel
  entry points stood in for), the x3 kernels refuse a call without its
  plan's order, and a CPU call runs the exact product and counts no
  launch;
- the tiny flagship on the x3 route (the x3 plain versions standing in for
  the kernels) against the JAX model to 1e-4.

``test_torch_conv_x3_card.py`` holds the kernels themselves to the plain
versions on the card.
"""
import contextlib
import types

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from msmdfusion_tpu.ops.sparse import matchconv as jmc

from msmdfusion_torch import kernels
from msmdfusion_torch.models import sparse_blocks
from msmdfusion_torch.ops.sparse import matchconv as tmc
from msmdfusion_torch.utils.convert import msmdfusion_rules
from tests.test_torch_conv_bf16_order import training_plan
from tests.test_torch_msmdfusion import build_pair, make_batch, tiny_config
from tests.test_torch_onehot import (assert_close, jax_flagship,  # noqa: F401
                                     one_thread, port_flagship)
from tests.test_torch_sparse_ops import both_tensors, random_sparse
from tests.test_torch_train_ops import STRIDED, jax_plan, port_plan, strided

JAX_TOL = 2.0 ** -20        # of each sum's magnitude: fp32 sum order
X3_TOL = 2.0 ** -15         # of each sum's magnitude: x3 against exact
SWITCHES = ('MSMD_CONV_GEMM', 'MSMD_CONV_DTYPE', 'MSMD_CONV_ALGO')


def set_env(monkeypatch, env):
    for k in SWITCHES:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


def held_to_sums(got, want, magnitude, tol):
    """Every element of ``got`` within ``tol`` of its sum's magnitude."""
    got, want, magnitude = (np.asarray(x, np.float64)
                            for x in (got, want, magnitude))
    assert np.isfinite(got).all()
    worst = float((np.abs(got - want) / np.maximum(magnitude, 1e-30)).max())
    assert worst <= tol, f'{worst:.3g} of the sums, above {tol:.3g}'
    return worst


def farther(got, want, magnitude, tol):
    """Some element of ``got`` lies more than ``tol`` of its sum's
    magnitude from ``want``: the two are different products."""
    worst = (np.abs(np.asarray(got, np.float64) - np.asarray(want))
             / np.maximum(np.asarray(magnitude, np.float64), 1e-30)).max()
    assert worst > tol, f'{worst:.3g}: not told apart at {tol:.3g}'


@pytest.mark.parametrize('value,mode', [
    (None, 'x3'), ('x3', 'x3'), ('highest', 'highest'), ('X3', None),
    ('tf32', None), ('fp32', None), ('', None)])
def test_gemm_mode_reads_the_switch(value, mode, monkeypatch):
    set_env(monkeypatch, {} if value is None else {'MSMD_CONV_GEMM': value})
    if mode is None:
        with pytest.raises(ValueError, match='MSMD_CONV_GEMM'):
            tmc.gemm_mode()
        return
    assert tmc.gemm_mode() == mode == jmc.gemm_mode()


@pytest.mark.parametrize('env,x3,packed,order', [
    ({}, True, False, True),
    ({'MSMD_CONV_GEMM': 'highest'}, False, False, False),
    ({'MSMD_CONV_DTYPE': 'bfloat16'}, False, True, True),
    ({'MSMD_CONV_DTYPE': 'bfloat16', 'MSMD_CONV_GEMM': 'highest'}, False,
     True, True),
    ({'MSMD_CONV_ALGO': 'onehot'}, False, False, False)])
def test_routes_follow_the_switches(env, x3, packed, order, monkeypatch):
    set_env(monkeypatch, env)
    assert (tmc.x3(), tmc.packed(), tmc.needs_order()) == (x3, packed, order)


@pytest.mark.parametrize('scale', [1e-30, 1e-3, 1.0, 1e3, 1e30])
def test_split_is_bit_equal_to_jax(scale):
    rng = np.random.RandomState(60)
    x = (rng.randn(4096) * scale).astype(np.float32)
    # ties (halfway between two bf16 values: to even) and bf16 values
    bits = x.view(np.int32)
    bits[:256] = bits[:256] & ~0xffff | 0x8000
    bits[256:512] &= ~0xffff
    hi, lo = tmc.split_hi_lo(torch.from_numpy(x))
    jhi, jlo = jmc._split_hi_lo(jnp.asarray(x))
    for got, want in ((hi, jhi), (lo, jlo)):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(
            got.numpy().view(np.int32),
            np.asarray(want.astype(jnp.float32)).view(np.int32))
    # hi is bf16-exact, lo is what hi leaves, to bf16
    assert torch.equal(tmc.bf16_round(hi), hi)
    assert torch.equal(tmc.bf16_round(torch.from_numpy(x) - hi), lo)


@pytest.mark.parametrize('k_cap,n_valid,shape,cin,cout', [
    (512, 400, (9, 24, 24), 16, 16), (256, 200, (5, 16, 16), 10, 8)])
def test_x3_plain_conv_matches_pallas(k_cap, n_valid, shape, cin, cout):
    rng = np.random.RandomState(61)
    j, t = both_tensors(*random_sparse(rng, k_cap, n_valid, shape, cin),
                        shape)
    jplan = jmc.attach_rows(j.keys, jmc.build_subm_plan(j, 3, tile=128),
                            interpret=True)
    rows = tmc.attach_rows(t.keys, tmc.build_subm_plan(t, 3)).rows
    w = (rng.randn(27, cin, cout) * 0.1).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    shift = rng.uniform(-0.3, 0.3, cout).astype(np.float32)
    wt = torch.from_numpy(w)
    assert jmc.gemm_mode() == 'x3'
    mag = tmc.gather_gemm_conv_plain(t.features.abs(), rows, wt.abs())
    want = np.asarray(jmc._vgather_conv(j.features, jplan, jnp.asarray(w),
                                        interpret=True))[:k_cap]
    got = tmc.gather_gemm_conv_plain(t.features, rows, wt, gemm='x3')
    held_to_sums(got, want, mag, JAX_TOL)
    farther(tmc.gather_gemm_conv_plain(t.features, rows, wt), want, mag,
            JAX_TOL)

    epi = dict(scale=torch.from_numpy(scale), shift=torch.from_numpy(shift),
               relu=True, out_valid=t.valid)
    want_epi = np.asarray(jmc._vgather_conv(
        j.features, jplan, jnp.asarray(w), interpret=True,
        scale=jnp.asarray(scale), shift=jnp.asarray(shift), relu=True,
        out_valid=jnp.asarray(t.valid.numpy())))[:k_cap]
    got_epi = tmc.gather_gemm_conv_plain(t.features, rows, wt, gemm='x3',
                                         **epi)
    held_to_sums(got_epi, want_epi, mag * epi['scale'] + epi['shift'].abs(),
                 JAX_TOL)
    # the epilogue runs on the fp32 sum of the x3 product
    assert torch.equal(got_epi, tmc.apply_epilogue(
        got, t.valid, epi['scale'], epi['shift'], True))
    assert (got_epi > 0).any() and (got_epi == 0).any()


@pytest.mark.parametrize('conv', STRIDED)
def test_x3_plain_backward_matches_pallas(conv):
    rng = np.random.RandomState(62)
    j, t, jout, tout = strided(rng, *conv)
    jplan, plan = jax_plan(j, jout, conv), port_plan(t, tout, conv)
    ta, cin, cout = plan.num_taps, 8, 12
    w = (rng.randn(ta, cin, cout) * 0.1).astype(np.float32)
    g = rng.randn(jplan.inb.shape[0], cout).astype(np.float32)
    d_feats, d_w = (np.asarray(x) for x in jmc._pallas_bwd(
        j.features, j.keys, jplan, jnp.asarray(w), jnp.asarray(g), 1024,
        None, interpret=True))
    gt = torch.from_numpy(g[:plan.k_out])
    w_t = torch.from_numpy(w).flip(0).transpose(1, 2).contiguous()
    rows = tmc.dual_rows(plan)
    mag = tmc.gather_gemm_conv_plain(gt.abs(), rows, w_t.abs())
    want = d_feats[:rows.shape[0]]
    held_to_sums(tmc.gather_gemm_conv_plain(gt, rows, w_t, gemm='x3'),
                 want, mag, JAX_TOL)
    farther(tmc.gather_gemm_conv_plain(gt, rows, w_t), want, mag, JAX_TOL)
    mag = tmc.conv_dw_plain(t.features.abs(), plan.rows, gt.abs())
    held_to_sums(tmc.conv_dw_plain(t.features, plan.rows, gt, gemm='x3'),
                 d_w, mag, JAX_TOL)
    farther(tmc.conv_dw_plain(t.features, plan.rows, gt), d_w, mag, JAX_TOL)


@pytest.mark.parametrize('fn', ['conv', 'dw'])
@pytest.mark.parametrize('cin,cout', [(5, 16), (64, 64), (96, 128)])
def test_x3_plain_within_2_15_of_exact(fn, cin, cout):
    rng = np.random.RandomState(63)
    k_in, k_out, ta = 600, 500, 27
    rows = rng.randint(0, k_in, (k_out, ta))
    rows[rng.rand(k_out, ta) > 0.4] = -1
    rows = torch.from_numpy(rows.astype(np.int32))
    # magnitudes over several binades, both signs: cancellation included
    feats = torch.from_numpy((rng.randn(k_in, cin)
                              * 2.0 ** rng.randint(-6, 6, (k_in, cin)))
                             .astype(np.float32))
    if fn == 'conv':
        w = torch.from_numpy(rng.randn(ta, cin, cout).astype(np.float32))
        got = tmc.gather_gemm_conv_plain(feats, rows, w, gemm='x3')
        want = tmc.gather_gemm_conv_plain(feats, rows, w)
        mag = tmc.gather_gemm_conv_plain(feats.abs(), rows, w.abs())
    else:
        g = torch.from_numpy(rng.randn(k_out, cout).astype(np.float32))
        got = tmc.conv_dw_plain(feats, rows, g, gemm='x3')
        want = tmc.conv_dw_plain(feats, rows, g)
        mag = tmc.conv_dw_plain(feats.abs(), rows, g.abs())
    worst = held_to_sums(got, want, mag, X3_TOL)
    assert worst > 2.0 ** -24          # x3 is not the exact product
    with pytest.raises(ValueError, match='gemm'):
        tmc.gather_gemm_conv_plain(feats, rows, torch.zeros(ta, cin, 4),
                                   gemm='tf32')


@pytest.mark.parametrize('env,order', [
    ({}, True), ({'MSMD_CONV_GEMM': 'highest'}, False),
    ({'MSMD_CONV_DTYPE': 'bfloat16'}, True),
    ({'MSMD_CONV_ALGO': 'onehot'}, False)])
@pytest.mark.parametrize('training', [False, True])
def test_fp32_blocks_build_the_order(env, order, training, monkeypatch):
    set_env(monkeypatch, env)
    rng = np.random.RandomState(64)
    _, t, _, _ = strided(rng, 3, 2, 1)
    torch.manual_seed(0)
    subm_layer = sparse_blocks.SubMConv3d(8, 8, 3, indice_key='s')
    down_layer = sparse_blocks.SparseConv3d(8, 8, 3, stride=2, padding=1,
                                            indice_key='d')
    subm_layer.train(training)
    down_layer.train(training)
    with torch.no_grad():
        _, cache = subm_layer(t, {})
        _, cache = down_layer(t, cache)
    subm = cache[('subm', 's')]
    plan = cache[('spconv', 'd')][-1]
    onehot = env.get('MSMD_CONV_ALGO') == 'onehot'
    assert (subm.rows is None) == onehot
    assert (subm.order is not None) == order
    assert (plan.order is not None) == order
    assert (plan.dual is not None) == training
    if training:
        assert (plan.dual.order is not None) == order
    if order:
        # the order of the plan's own rows; the weight gradient's pairs in
        # training, never for the dual (only the input gradient reads it)
        assert torch.equal(plan.order.perm, tmc.row_order(plan.rows).perm)
        for p in (subm, plan):
            assert (p.order.tap_hits is not None) == training
        if training:
            assert plan.dual.order.tap_hits is None
            assert tmc.dual_order(subm) is subm.order
            assert tmc.dual_order(plan) is plan.dual.order


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers as on the card, with each kernel's C entry point stood
    in for by a recorder: [(kernel, its arguments)]."""
    seen = []

    def entry_point(name):
        def launch(*args):
            seen.append((name, args))
            return 0
        return launch
    monkeypatch.setattr(kernels, 'use_kernel', lambda t: True)
    monkeypatch.setattr(kernels, 'entry_point', entry_point)
    monkeypatch.setattr(torch.cuda, 'device',
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    kernels.reset_launches()
    yield seen
    kernels.reset_launches()


@pytest.mark.parametrize('env,conv,dw', [
    ({}, 'gather_gemm_conv_x3', 'conv_dw_x3'),
    ({'MSMD_CONV_GEMM': 'x3'}, 'gather_gemm_conv_x3', 'conv_dw_x3'),
    ({'MSMD_CONV_GEMM': 'highest'}, 'gather_gemm_conv', 'conv_dw'),
    ({'MSMD_CONV_DTYPE': 'bfloat16'}, 'gather_gemm_conv_bf16',
     'conv_dw_bf16'),
    ({'MSMD_CONV_ALGO': 'onehot'}, 'gather_gemm_conv', 'conv_dw')])
def test_wrappers_launch_the_routes_kernel(env, conv, dw, fake_card,
                                           monkeypatch):
    set_env(monkeypatch, env)
    rng = np.random.RandomState(65)
    rows = torch.from_numpy(rng.randint(-1, 50, (40, 27)).astype(np.int32))
    feats = torch.from_numpy(rng.randn(50, 16).astype(np.float32))
    w = torch.from_numpy(rng.randn(27, 16, 24).astype(np.float32))
    g = torch.from_numpy(rng.randn(40, 24).astype(np.float32))
    order = tmc.row_order(rows)
    tmc.gather_gemm_conv(feats, rows, w, order=order)
    tmc.conv_dw(feats, rows, g, order=order)
    assert [name for name, _ in fake_card] == [conv, dw]
    assert {k: v for k, v in kernels.launches.items() if v} == \
        {conv: 1, dw: 1}
    # each call's arguments match its C entry point's signature
    for name, args in fake_card:
        assert len(args) == len(kernels.ENTRY_POINTS[name][2])
    if conv == 'gather_gemm_conv_x3':
        # the weights split once per call, hi and lo laid out for the
        # kernel's bulk copies (np 32, one column block)
        laid, np_, col_blocks = tmc.x3_layout(w)
        assert (np_, col_blocks) == (32, 1)
        assert laid.shape == (1, 27, 1, 2, 4, 2, 8, 8)
        assert fake_card[0][1][8:11] == (32, 1, 24)
        # [Ta, group, half, column, k] -> [Ta, Cin, Cout]
        parts = [laid[0, :, 0, i].permute(0, 2, 4, 1, 3).reshape(27, 16, 32)
                 for i in (0, 1)]
        assert torch.equal(parts[0][..., :24].float() +
                           parts[1][..., :24].float(),
                           sum(tmc.split_hi_lo(w)))
        assert not parts[0][..., 24:].any() and not parts[1][..., 24:].any()
    if conv != 'gather_gemm_conv':
        # the tensor-core kernels walk the plan's order: never built per
        # call
        with pytest.raises(ValueError, match='row order'):
            tmc.gather_gemm_conv(feats, rows, w)
        with pytest.raises(ValueError, match='pair lists'):
            tmc.conv_dw(feats, rows, g,
                        order=tmc.row_order(rows, pairs=False))


def test_matchconv_hands_the_plans_orders_to_the_x3_kernels(monkeypatch):
    set_env(monkeypatch, {})
    rng = np.random.RandomState(66)
    _, t, _, tout = strided(rng, 3, 2, 1)
    plan = training_plan(t, tout)
    seen = []

    def conv(feats, rows, weights, order=None, **kw):
        seen.append(('conv', order))
        return tmc.gather_gemm_conv_plain(feats, rows, weights, gemm='x3',
                                          **kw)

    def dw(feats, rows, g, order=None):
        seen.append(('dw', order))
        return tmc.conv_dw_plain(feats, rows, g, gemm='x3')
    monkeypatch.setattr(tmc, 'gather_gemm_conv', conv)
    monkeypatch.setattr(tmc, 'conv_dw', dw)
    feats = t.features.clone().requires_grad_(True)
    w = torch.randn(27, 8, 6, requires_grad=True)
    tmc.MatchConv.apply(feats, w, plan).sum().backward()
    assert [(k, id(o)) for k, o in seen] == [
        ('conv', id(plan.order)), ('conv', id(plan.dual.order)),
        ('dw', id(plan.order))]


@pytest.mark.parametrize('env', [{}, {'MSMD_CONV_GEMM': 'highest'}])
def test_cpu_calls_are_exact_and_never_count(env, monkeypatch):
    set_env(monkeypatch, env)
    rng = np.random.RandomState(67)
    rows = torch.from_numpy(rng.randint(-1, 50, (40, 27)).astype(np.int32))
    feats = torch.from_numpy(rng.randn(50, 16).astype(np.float32))
    w = torch.from_numpy(rng.randn(27, 16, 8).astype(np.float32))
    g = torch.from_numpy(rng.randn(40, 8).astype(np.float32))
    kernels.reset_launches()
    # no order needed: a CPU tensor takes the exact plain product
    assert torch.equal(tmc.gather_gemm_conv(feats, rows, w),
                       tmc.gather_gemm_conv_plain(feats, rows, w,
                                                  gemm='exact'))
    assert torch.equal(tmc.conv_dw(feats, rows, g),
                       tmc.conv_dw_plain(feats, rows, g, gemm='exact'))
    assert not any(kernels.launches.values())
    assert set(kernels.launches) >= {'gather_gemm_conv_x3', 'conv_dw_x3'}
    assert not kernels.use_kernel(feats)


@pytest.fixture(scope='module')
def tiny():
    batch = make_batch(np.random.RandomState(0))
    jmodel, variables, port = build_pair(
        tiny_config(), batch, msmdfusion_rules(depth=18, layer_nums=(2, 2)))
    return port, batch, jax_flagship(jmodel, variables, batch)


def test_tiny_flagship_x3_route_matches_jax(tiny, monkeypatch):
    """Every conv of the tiny flagship on the x3 product (the plain x3
    version standing for the kernel, with the plan's order it is handed)
    against the JAX model, which off the TPU runs its exact fp32
    ``_fallback_conv``: 1e-4 of the largest value, the port's own fp32
    tolerance (x3 is ~2^-17 of each sum's magnitude)."""
    port, batch, (jx, jpreds, jboxes) = tiny
    set_env(monkeypatch, {})
    orders = []

    def x3_conv(feats, rows, weights, order=None, **kwargs):
        orders.append(order is not None
                      and order.perm.shape[0] == rows.shape[0])
        return tmc.gather_gemm_conv_plain(feats, rows, weights, gemm='x3',
                                          **kwargs)
    monkeypatch.setattr(tmc, 'gather_gemm_conv', x3_conv)
    x, preds, boxes = port_flagship(port, batch)
    assert orders == [True] * 37
    assert_close(x.numpy(), jx, msg='head input')
    np.testing.assert_array_equal(preds['query_labels'].numpy(),
                                  np.asarray(jpreds['query_labels']))
    for key in ('dense_heatmap', 'heatmap', 'center', 'dim'):
        assert_close(preds[key].numpy(), jpreds[key], msg=key)
    for key in ('bboxes', 'scores'):
        assert_close(boxes[key].numpy(), jboxes[key], msg=key)
    # x3 moved the head input off the exact product: the route was taken
    monkeypatch.undo()
    exact, _, _ = port_flagship(port, batch)
    assert not torch.equal(x, exact)
