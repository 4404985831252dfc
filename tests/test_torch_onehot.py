"""The port's one-hot sparse-conv engine (``MSMD_CONV_ALGO=onehot``) vs the
JAX package on the CPU.

The same numpy inputs go through the JAX functions and the port's. On the
CPU the port's ``match_conv`` runs its plain version; the JAX one-hot
kernel ``_match_kernel`` runs in Pallas interpret mode through
``_pallas_conv``, as its tests run the package's kernels.

- ``match_conv`` (plain) against ``_pallas_conv(..., interpret=True)`` on
  subm, strided and dual (explicit-query) plans, with and without the
  fused epilogue, to 1e-4 of the largest value (the TPU kernel splits the
  features into bf16 hi/lo, ~2^-16 relative).
- The one-hot ``MatchConv`` backward on rowless plans (``d_feats`` by
  ``match_conv`` over the transpose plan, ``dw`` by ``conv_dw`` over rows
  built in the backward) against ``_pallas_bwd(..., interpret=True)`` on
  rowless JAX plans and against the VJP of ``_fallback_conv``, to 2e-4
  (the JAX tests' own).
- The tiny flagship of ``test_torch_msmdfusion.py`` under the switch
  against the JAX model (off the TPU the JAX model runs ``_fallback_conv``
  whatever the switch) to 1e-4, with no rulebook attached; and its
  train-mode losses and gradients equal the rulebook engine's bit for bit
  (both run the same plain rows and sums on the CPU).
- Unknown switch values raise; the kernels' library names hash the
  headers their sources include.
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from msmdfusion_tpu.ops.sparse import matchconv as jmc

from msmdfusion_torch import kernels
from msmdfusion_torch.apis.train import total_loss
from msmdfusion_torch.models import sparse_blocks
from msmdfusion_torch.ops.sparse import matchconv as tmc
from msmdfusion_torch.utils import overflow
from msmdfusion_torch.utils.convert import msmdfusion_rules
from tests.test_torch_msmdfusion import (build_pair, jax_inputs, make_batch,
                                         port_inputs, tiny_config)
from tests.test_torch_train_ops import BWD_TOL, STRIDED, strided
from tests.test_torch_train_step import make_gt, train_config

TOL = 1e-4
INT_MAX = 2 ** 31 - 1


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """One intra-op thread for the port's CPU ops: the test files run in
    several worker processes that share the cores, where the default
    thread pools oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rowless_plans(j, t, jout, tout, conv):
    """(JAX plan, port plan) without rulebook rows: subm, or strided with
    its dual and the dual's keys attached."""
    if conv == 'subm':
        return jmc.build_subm_plan(j, 3, tile=128), tmc.build_subm_plan(t, 3)
    ks, stride, pad = conv
    out_keys, out_coords, out_valid, out_shape = jout
    jplan = dataclasses.replace(
        jmc.build_downsample_plan(j, out_coords, out_valid, ks, stride, pad,
                                  tile=128),
        dual=jmc.build_dual_down_plan(j, out_keys, out_shape, ks, stride,
                                      pad, tile=128),
        dual_keys=out_keys)
    keys, coords, valid, shape = tout
    tplan = dataclasses.replace(
        tmc.build_downsample_plan(t, coords, valid, ks, stride, pad),
        dual=tmc.build_dual_down_plan(t, shape, ks, stride, pad),
        dual_keys=keys)
    return jplan, tplan


def assert_close(got, want, tol=TOL, msg=''):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * np.abs(want).max(), err_msg=msg)


@pytest.mark.parametrize('conv,plan_kind', [
    ('subm', 'forward'), (STRIDED[0], 'forward'), (STRIDED[1], 'forward'),
    (STRIDED[0], 'dual'), (STRIDED[1], 'dual')])
def test_match_conv_matches_pallas_conv(conv, plan_kind):
    rng = np.random.RandomState(20)
    ks, stride, pad = (3, 1, 1) if conv == 'subm' else conv
    j, t, jout, tout = strided(rng, ks, stride, pad)
    jplan, tplan = rowless_plans(j, t, jout, tout, conv)
    cin, cout = 8, 12
    if plan_kind == 'dual':
        # the transpose conv: gathers over the strided output set
        jplan, tplan = jplan.dual, tplan.dual
        keys = tout[0]
        feats = (rng.randn(keys.shape[0], cin) *
                 (keys != INT_MAX).numpy()[:, None]).astype(np.float32)
        out_valid = t.valid
    else:
        keys, feats = t.keys, t.features.numpy()
        out_valid = t.valid if conv == 'subm' else tout[2]
    k_out = tplan.k_out
    w = (rng.randn(tplan.num_taps, cin, cout) * 0.2).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    shift = rng.uniform(-0.3, 0.3, cout).astype(np.float32)
    jf, jk = jnp.asarray(feats), jnp.asarray(keys.numpy())

    kernels.reset_launches()
    with overflow.capture() as cap:
        got = tmc.match_conv(torch.from_numpy(feats), keys, tplan,
                             torch.from_numpy(w))
    want = jmc._pallas_conv(jf, jk, jplan, jnp.asarray(w), interpret=True)
    assert_close(got.numpy(), np.asarray(want)[:k_out], msg='no epilogue')
    rows = tmc.plan_rows_plain(keys, tplan)
    assert (rows >= 0).sum() > 200            # real neighbours matched
    assert cap.counters() == {'matchconv.slab': 0}

    epi = tmc.match_conv(torch.from_numpy(feats), keys, tplan,
                         torch.from_numpy(w), scale=torch.from_numpy(scale),
                         shift=torch.from_numpy(shift), relu=True,
                         out_valid=out_valid)
    want_epi = jmc._pallas_conv(
        jf, jk, jplan, jnp.asarray(w), interpret=True,
        scale=jnp.asarray(scale), shift=jnp.asarray(shift), relu=True,
        out_valid=jnp.asarray(out_valid.numpy()))
    assert_close(epi.numpy(), np.asarray(want_epi)[:k_out], msg='epilogue')
    assert (epi.numpy() > 0).any() and (epi.numpy() == 0).any()
    assert not epi[~out_valid].any()
    # on CPU tensors the wrapper is the plain version and counts nothing
    assert sum(kernels.launches.values()) == 0


def test_invalid_rows_never_match_a_real_key():
    """An INT_MAX row plus a tap offset may land on a real key (here 5) or
    wrap past INT_MAX: it matches nothing, whatever ``inb`` says; the sums
    run in 64 bits."""
    keys = torch.tensor([0, 5, 9, INT_MAX], dtype=torch.int32)
    plan = tmc.MatchPlan(
        inb=torch.ones(2, 2, dtype=torch.bool),
        okeys=torch.tensor([4, INT_MAX], dtype=torch.int32),
        dkey=torch.tensor([1, -INT_MAX + 5], dtype=torch.int32))
    feats = torch.arange(8, dtype=torch.float32).reshape(4, 2)
    out = tmc.match_conv(feats, keys, plan, torch.ones(2, 2, 1))
    # row 0 matches key 5 (input row 1) at tap 0 only; row 1 nothing
    np.testing.assert_array_equal(out.numpy(), [[5.0], [0.0]])


@pytest.mark.parametrize('conv', ['subm'] + STRIDED)
def test_onehot_backward_matches_jax(conv, monkeypatch):
    monkeypatch.setenv('MSMD_CONV_ALGO', 'onehot')
    rng = np.random.RandomState(21)
    ks, stride, pad = (3, 1, 1) if conv == 'subm' else conv
    j, t, jout, tout = strided(rng, ks, stride, pad)
    jplan, tplan = rowless_plans(j, t, jout, tout, conv)
    assert tplan.rows is None and (conv == 'subm' or tplan.dual.rows is None)
    ta, cin, cout = tplan.num_taps, 8, 12
    w = (rng.randn(ta, cin, cout) * 0.1).astype(np.float32)
    k_pad = jplan.inb.shape[0]
    g = rng.randn(k_pad, cout).astype(np.float32)

    built = []

    def counting(*args):
        built.append(args[1])
        return tmc.plan_rows_plain(*args)
    monkeypatch.setattr(tmc, 'plan_rows', counting)
    feats = t.features.clone().requires_grad_(True)
    weights = torch.from_numpy(w).requires_grad_(True)
    if conv == 'subm':
        out_coords, out_valid, out_keys, out_shape = (
            t.coords, t.valid, t.keys, t.spatial_shape)
    else:
        out_keys, out_coords, out_valid, out_shape = tout
    out = tmc.apply_match_conv(t.replace_features(feats), tplan, weights,
                               out_coords, out_valid, out_keys, out_shape)
    assert not built
    out.features.backward(torch.from_numpy(g[:tplan.k_out]))
    assert built == [tplan]             # the dw rows: one build per conv

    jw = jnp.asarray(w)
    want = jmc._pallas_bwd(j.features, j.keys, jplan, jw, jnp.asarray(g),
                           1024, None, interpret=True)
    _, vjp = jax.vjp(lambda f, w_: jmc._fallback_conv(f, j.keys, jplan, w_),
                     j.features, jw)
    for gf, gw in (want, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(feats.grad.numpy(), np.asarray(gf),
                                   rtol=BWD_TOL, atol=BWD_TOL)
        np.testing.assert_allclose(weights.grad.numpy(), np.asarray(gw),
                                   rtol=BWD_TOL, atol=BWD_TOL)


def test_rowless_plan_needs_the_switch_and_a_dual(monkeypatch):
    j, t, jout, tout = strided(np.random.RandomState(22), 3, 2, 1)
    _, plan = rowless_plans(j, t, jout, tout, (3, 2, 1))
    keys, coords, valid, shape = tout
    weights = torch.randn(27, 8, 4, requires_grad=True)
    with pytest.raises(ValueError, match='no rows'):
        tmc.apply_match_conv(t, plan, weights, coords, valid, keys, shape)
    monkeypatch.setenv('MSMD_CONV_ALGO', 'onehot')
    feats = t.features.clone().requires_grad_(True)
    out = tmc.apply_match_conv(t.replace_features(feats),
                               dataclasses.replace(plan, dual=None), weights,
                               coords, valid, keys, shape)
    with pytest.raises(ValueError, match='no dual'):
        out.features.sum().backward()


@pytest.mark.parametrize('var,value', [
    ('MSMD_CONV_ALGO', 'vgather2'), ('MSMD_CONV_ALGO', ''),
    ('MSMD_CONV_DTYPE', 'float16'), ('MSMD_CONV_DTYPE', 'bf16')])
def test_unknown_switch_values_raise(var, value, monkeypatch):
    monkeypatch.setenv(var, value)
    with pytest.raises(ValueError, match=var):
        tmc.packed()
    j, t, jout, tout = strided(np.random.RandomState(23), 3, 1, 1)
    plan = tmc.attach_rows(t.keys, tmc.build_subm_plan(t, 3))
    with pytest.raises(ValueError, match=var):
        tmc.apply_match_conv(t, plan, torch.zeros(27, 8, 4), t.coords,
                             t.valid, t.keys, t.spatial_shape)


def test_switch_defaults(monkeypatch):
    monkeypatch.delenv('MSMD_CONV_ALGO', raising=False)
    monkeypatch.delenv('MSMD_CONV_DTYPE', raising=False)
    assert (tmc.conv_algo(), tmc.conv_dtype()) == ('vgather', 'float32')
    assert not tmc.packed()
    monkeypatch.setenv('MSMD_CONV_DTYPE', 'bfloat16')
    assert tmc.packed()
    monkeypatch.setenv('MSMD_CONV_ALGO', 'onehot')   # ignores the dtype
    assert tmc.conv_algo() == 'onehot' and not tmc.packed()


def test_lib_path_hashes_included_headers(tmp_path, monkeypatch):
    monkeypatch.setattr(kernels, 'CSRC', tmp_path)
    (tmp_path / 'a.cuh').write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / 'b.cuh').write_text('#define B 1\n')
    (tmp_path / 'k.cu').write_text('#include <stdint.h>\n#include "a.cuh"\n')
    first = kernels._lib_path('k')
    assert kernels.source_files('k') == [tmp_path / 'k.cu',
                                         tmp_path / 'a.cuh',
                                         tmp_path / 'b.cuh']
    (tmp_path / 'b.cuh').write_text('#define B 2\n')
    second = kernels._lib_path('k')
    assert second != first and second.parent == first.parent
    monkeypatch.undo()
    assert kernels.CSRC / 'key_search.cuh' in kernels.source_files(
        'match_conv')
    assert kernels.CSRC / 'key_search.cuh' in kernels.source_files(
        'rows_affine')


def jax_flagship(jmodel, variables, batch):
    """(head input [B, H, W, C], preds, boxes) of the JAX model in eval
    mode: its ``__call__`` and ``get_bboxes``, keeping the head's input."""
    def run(m, points, mask, img, fg):
        hw = (img.shape[2], img.shape[3])
        x = m.extract_pts_feat(points, mask, m.extract_img_feat(img, False),
                               fg, hw, False)[0]
        preds = m.bbox_head(x, train=False)
        return x, preds, m.bbox_head.get_bboxes(preds)
    return jax.jit(lambda v, *a: jmodel.apply(v, *a, method=run))(
        variables, *jax_inputs(batch))


def port_flagship(port, batch):
    """(head input [B, H, W, C], preds, boxes) of the port in eval mode."""
    kept = []
    hook = port.pts_bbox_head.register_forward_pre_hook(
        lambda module, args: kept.append(args[0]))
    try:
        with torch.no_grad(), overflow.capture() as cap:
            preds = port(*port_inputs(batch))
            boxes = port.get_bboxes(preds)
    finally:
        hook.remove()
    assert cap.total() == 0, cap.counters()
    return kept[0].permute(0, 2, 3, 1), preds, boxes


@pytest.fixture(scope='module')
def tiny():
    batch = make_batch(np.random.RandomState(0))
    jmodel, variables, port = build_pair(
        tiny_config(), batch, msmdfusion_rules(depth=18, layer_nums=(2, 2)))
    return port, batch, jax_flagship(jmodel, variables, batch)


def test_tiny_flagship_onehot_matches_jax(tiny, monkeypatch):
    port, batch, (jx, jpreds, jboxes) = tiny
    monkeypatch.setenv('MSMD_CONV_ALGO', 'onehot')
    convs, attached = [], []

    def counting(*args, **kwargs):
        convs.append(args[2].num_taps)
        return tmc.match_conv_plain(*args, **kwargs)
    monkeypatch.setattr(tmc, 'match_conv', counting)
    monkeypatch.setattr(sparse_blocks, 'attach_rows',
                        lambda *a, **k: attached.append(a))
    x, preds, boxes = port_flagship(port, batch)
    assert len(convs) == 37 and not attached    # every conv, no rulebook
    assert_close(x.numpy(), jx, msg='head input')
    np.testing.assert_array_equal(preds['query_labels'].numpy(),
                                  np.asarray(jpreds['query_labels']))
    for key in ('dense_heatmap', 'heatmap', 'center', 'dim'):
        assert_close(preds[key].numpy(), jpreds[key], msg=key)
    for key in ('bboxes', 'scores'):
        assert_close(boxes[key].numpy(), jboxes[key], msg=key)


def test_tiny_flagship_onehot_train_equals_rulebook_engine(monkeypatch):
    """Train mode (dual plans, the one-hot backward with its rows built
    per conv): the same losses and gradients as the rulebook engine."""
    rng = np.random.RandomState(0)
    batch = make_batch(rng)
    gt = {k: torch.from_numpy(v) for k, v in make_gt(rng).items()}
    _, _, port = build_pair(train_config(), batch,
                            msmdfusion_rules(depth=18, layer_nums=(2, 2)))
    port.train()

    def step():
        port.zero_grad(set_to_none=True)
        preds = port(*port_inputs(batch))
        losses = port.loss(preds, gt['gt_bboxes'], gt['gt_labels'],
                           gt['gt_valid'])
        total_loss(losses).backward()
        return ({k: v.detach() for k, v in losses.items()},
                {n: p.grad.clone() for n, p in port.named_parameters()
                 if p.grad is not None})

    state = {k: v.clone() for k, v in port.state_dict().items()}
    want_losses, want = step()
    port.load_state_dict(state)
    monkeypatch.setenv('MSMD_CONV_ALGO', 'onehot')
    got_losses, got = step()
    assert set(got_losses) == set(want_losses)
    for key, value in want_losses.items():
        assert torch.equal(got_losses[key], value), key
    assert set(got) == set(want) and len(got) > 100
    for name, value in want.items():
        assert torch.equal(got[name], value), name
