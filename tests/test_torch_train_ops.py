"""Port training ops vs the JAX package on the CPU.

The same numpy inputs go through the JAX functions and the port's:

- the transpose ("dual") plan of a strided conv and its rulebook rows
  (the port's ``rows_queries`` runs its plain version here) against
  ``build_dual_down_plan`` and ``plan_rows`` in Pallas interpret mode
  (kernel ``_rows_kernel``): equal;
- the sparse conv's backward (``MatchConv``: ``d_feats`` over the dual
  rows, ``dw`` by ``conv_dw``'s plain version) against the JAX package's
  dual-plan backward ``_pallas_bwd`` in interpret mode (kernel
  ``_vgather_kernel`` with ``with_dw``) and against the VJP of its
  ``_fallback_conv``, at rtol/atol 2e-4 (the JAX tests' own);
- ``merge_take``'s backward against ``jax.grad``: exact, it adds the same
  fp32 rows;
- ``MaskedBatchNorm`` in training mode: outputs and running statistics
  against the JAX module's, to 1e-5 (the same moments, summed in another
  order).
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from msmdfusion_tpu.models.layers import MaskedBatchNorm as JaxBatchNorm
from msmdfusion_tpu.ops.sparse import conv as jconv
from msmdfusion_tpu.ops.sparse import matchconv as jmc
from msmdfusion_tpu.ops.sparse.merge_take import \
    merge_take_rows as jax_merge_take

from msmdfusion_torch.models.layers import MaskedBatchNorm
from msmdfusion_torch.ops.sparse import conv as tconv
from msmdfusion_torch.ops.sparse import matchconv as tmc
from msmdfusion_torch.ops.sparse.merge_take import merge_take_rows
from tests.test_torch_sparse_ops import both_tensors, random_sparse

SHAPE = (8, 20, 20)
STRIDED = [(3, 2, 1), ((3, 1, 1), (2, 1, 1), 0)]
BWD_TOL = 2e-4


def strided(rng, ks, stride, pad, c=8):
    """(JAX tensor, port tensor, JAX out set, port out set) of a random
    coordinate set and its strided conv's output coordinates."""
    feats, coords, valid = random_sparse(rng, 384, 300, SHAPE, c)
    j, t = both_tensors(feats, coords, valid, SHAPE)
    return (j, t, jconv.downsample_out_coords(j, ks, stride, pad, 256),
            tconv.downsample_out_coords(t, ks, stride, pad, 256))


@pytest.mark.parametrize('ks,stride,pad', STRIDED)
def test_dual_plan_and_rows_match_jax(ks, stride, pad):
    j, t, jout, tout = strided(np.random.RandomState(0), ks, stride, pad)
    out_keys, _, _, out_shape = jout
    assert tuple(int(v) for v in out_shape) == tuple(tout[3])
    np.testing.assert_array_equal(np.asarray(out_keys), tout[0].numpy())
    jdual = jmc.build_dual_down_plan(j, out_keys, out_shape, ks, stride,
                                     pad, tile=128)
    tdual = tmc.build_dual_down_plan(t, tout[3], ks, stride, pad)
    k = t.capacity
    np.testing.assert_array_equal(np.asarray(jdual.inb)[:k],
                                  tdual.inb.numpy())
    np.testing.assert_array_equal(np.asarray(jdual.queries)[:k],
                                  tdual.queries.numpy())
    want = np.asarray(jmc.plan_rows(out_keys, jdual, interpret=True))[:k]
    got = tmc.attach_rows(tout[0], tdual).rows
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tmc.rows_queries_plain(tout[0], tdual.queries, tdual.inb).numpy(),
        want)
    assert (want >= 0).sum() > 100

    # the dual rows enumerate the forward rulebook's pairs, taps reversed
    fwd = tmc.attach_rows(t.keys, tmc.build_downsample_plan(
        t, tout[1], tout[2], ks, stride, pad)).rows.numpy()
    ta = fwd.shape[1]
    pairs_f = {(tap, o, i) for (o, tap), i in np.ndenumerate(fwd) if i >= 0}
    pairs_d = {(ta - 1 - u, o, i) for (i, u), o in np.ndenumerate(want)
               if o >= 0}
    assert pairs_f == pairs_d


def port_plan(t, tout, conv):
    """The port's training plan: subm (its own transpose) or strided with
    its dual attached."""
    if conv == 'subm':
        return tmc.attach_rows(t.keys, tmc.build_subm_plan(t, 3))
    ks, stride, pad = conv
    out_keys, out_coords, out_valid, out_shape = tout
    plan = tmc.attach_rows(t.keys, tmc.build_downsample_plan(
        t, out_coords, out_valid, ks, stride, pad))
    dual = tmc.attach_rows(out_keys, tmc.build_dual_down_plan(
        t, out_shape, ks, stride, pad))
    return dataclasses.replace(plan, dual=dual)


def jax_plan(j, jout, conv):
    if conv == 'subm':
        return jmc.attach_rows(j.keys, jmc.build_subm_plan(j, 3, tile=128),
                               interpret=True)
    ks, stride, pad = conv
    out_keys, out_coords, out_valid, out_shape = jout
    plan = jmc.attach_rows(j.keys, jmc.build_downsample_plan(
        j, out_coords, out_valid, ks, stride, pad, tile=128), interpret=True)
    dual = jmc.attach_rows(out_keys, jmc.build_dual_down_plan(
        j, out_keys, out_shape, ks, stride, pad, tile=128), interpret=True)
    return dataclasses.replace(plan, dual=dual, dual_keys=out_keys)


@pytest.mark.parametrize('conv', ['subm'] + STRIDED)
def test_match_conv_backward_matches_jax(conv):
    rng = np.random.RandomState(1)
    ks, stride, pad = (3, 1, 1) if conv == 'subm' else conv
    j, t, jout, tout = strided(rng, ks, stride, pad)
    jplan, plan = jax_plan(j, jout, conv), port_plan(t, tout, conv)
    ta, cin, cout = plan.num_taps, 8, 12
    w = (rng.randn(ta, cin, cout) * 0.1).astype(np.float32)
    k_pad = jplan.inb.shape[0]
    g = rng.randn(k_pad, cout).astype(np.float32)

    feats = t.features.clone().requires_grad_(True)
    weights = torch.from_numpy(w).requires_grad_(True)
    out = tmc.MatchConv.apply(feats, weights, plan)
    out.backward(torch.from_numpy(g[:plan.k_out]))

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
    # the forward rows and the dual rows give the same weight gradient
    dual = plan.rows if conv == 'subm' else plan.dual.rows
    gt = torch.from_numpy(g[:plan.k_out])
    via_dual = tmc.conv_dw_plain(gt, dual, feats.detach()).flip(0) \
        .transpose(1, 2)
    np.testing.assert_allclose(via_dual.numpy(), weights.grad.numpy(),
                               rtol=BWD_TOL, atol=BWD_TOL)


def test_input_gradient_skipped_when_not_needed():
    j, t, jout, tout = strided(np.random.RandomState(2), 3, 2, 1)
    plan = port_plan(t, tout, (3, 2, 1))
    weights = torch.randn(27, 8, 4, requires_grad=True)
    out = tmc.MatchConv.apply(t.features, weights, plan)
    out.sum().backward()
    assert weights.grad is not None and t.features.grad is None
    with pytest.raises(ValueError, match='no dual rows'):
        tmc.dual_rows(dataclasses.replace(plan, dual=None))


@pytest.mark.parametrize('k_out,ta,cin,cout', [
    (0, 27, 16, 16), (1, 27, 5, 16), (1000, 3, 192, 192),
    (166044, 27, 16, 16), (171317, 27, 96, 96), (21281, 3, 128, 128)])
def test_conv_dw_launch_covers_every_row(k_out, ta, cin, cout):
    tile, n_chunks, chunk_rows = tmc.conv_dw_launch(k_out, ta, cin, cout)
    assert tile in (16, 32, 64) and n_chunks >= 1
    assert n_chunks * chunk_rows >= k_out
    assert (n_chunks - 1) * chunk_rows < max(k_out, 1)


def two_halves(rng, n_a=900, n_b=800, c=24):
    """sparse_add's gather streams over two key-sorted halves with
    overlapping keys and INT_MAX tails."""
    common = rng.choice(10 ** 5, 300, replace=False)
    ka = np.union1d(common, rng.choice(10 ** 5, 500, replace=False))
    kb = np.union1d(common, rng.choice(10 ** 5, 450, replace=False))
    imax = 2 ** 31 - 1
    ka = np.concatenate([ka, np.full(n_a - len(ka), imax)])
    kb = np.concatenate([kb, np.full(n_b - len(kb), imax)])
    keys = np.concatenate([ka, kb])
    order = np.argsort(keys, kind='stable')
    skey = keys[order]
    head = np.concatenate([[True], skey[1:] != skey[:-1]]) & (skey != imax)
    hp = np.where(head)[0]
    nxt = np.minimum(hp + 1, len(keys) - 1)
    dup = (nxt > hp) & (skey[nxt] == skey[hp])
    m = len(hp) + 100                           # output rows, some unused
    idx = np.full(m, imax, np.int32)
    idx[:len(hp)] = order[hp]
    idx2 = np.zeros(m, np.int32)
    idx2[:len(hp)] = order[nxt]
    dupm = np.zeros(m, bool)
    dupm[:len(hp)] = dup
    table = rng.randn(n_a + n_b, c).astype(np.float32)
    return table, idx, idx2, dupm, n_a


def test_merge_take_backward_matches_jax_grad():
    rng = np.random.RandomState(3)
    table, idx, idx2, dup, n_a = two_halves(rng)
    cot = rng.randn(len(idx), table.shape[1]).astype(np.float32)
    want = jax.grad(lambda tb: jnp.vdot(jax_merge_take(
        tb, jnp.asarray(idx), n_a, jnp.asarray(idx2), jnp.asarray(dup),
        interpret=True), jnp.asarray(cot)))(jnp.asarray(table))
    t = torch.from_numpy(table).requires_grad_(True)
    out = merge_take_rows(t, torch.from_numpy(idx), torch.from_numpy(idx2),
                          torch.from_numpy(dup))
    out.backward(torch.from_numpy(cot))
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(want))
    assert dup.sum() > 100 and (idx == 2 ** 31 - 1).sum() > 0


@pytest.mark.parametrize('masked', [False, True])
def test_masked_batch_norm_training_matches_jax(masked):
    rng = np.random.RandomState(4)
    k, c = 500, 24
    x = (rng.randn(k, c) * 3 + 1).astype(np.float32)
    mask = rng.rand(k) < 0.7 if masked else None
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = (rng.randn(c) * 0.1).astype(np.float32)
    mean = (rng.randn(c) * 0.1).astype(np.float32)
    var = rng.uniform(0.5, 1.5, c).astype(np.float32)
    jbn = JaxBatchNorm(momentum=0.01, eps=1e-3)
    variables = {'params': {'scale': scale, 'bias': bias},
                 'batch_stats': {'mean': mean, 'var': var}}
    want, mutated = jbn.apply(variables, jnp.asarray(x),
                              None if mask is None else jnp.asarray(mask),
                              train=True, mutable=['batch_stats'])
    bn = MaskedBatchNorm(c, eps=1e-3, momentum=0.01).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean))
        bn.running_var.copy_(torch.from_numpy(var))
    got = bn(torch.from_numpy(x),
             None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    stats = mutated['batch_stats']
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(stats['mean']), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(stats['var']), rtol=1e-5,
                               atol=1e-6)
    if masked:
        assert not got[~torch.from_numpy(mask)].any()
    with pytest.raises(ValueError, match='eval-mode'):
        bn.fold()
