"""The port's packed bf16 sparse-conv engine (``MSMD_CONV_DTYPE=bfloat16``)
vs the JAX package on the CPU.

Under the switch the rulebook engine rounds the features (the gradient,
in the backward's input-gradient conv) and the unscaled weights to bf16,
multiplies and sums in fp32 and applies the epilogue to the fp32 sum; the
weight gradient rounds the gathered input rows and the gradient rows. On
the CPU the port runs its plain versions, which round at those places;
the JAX package's packed kernel (``_vgather_kernel`` with ``packed``) runs
in Pallas interpret mode.

- The conv at C 16 -> 16 and 10 -> 8 (the JAX test's shapes, Cin 10 pads
  to 16) against ``_vgather_conv(..., interpret=True)``: the same rounded
  operands, so within 1e-4 of the largest value; both within 2e-2 of the
  fp32 oracle (bf16 keeps 8 bits).
- The packed backward (``d_feats`` and ``dw``) against
  ``_pallas_bwd(..., interpret=True)`` on a strided plan, to 1e-4.
- The tiny flagship under the switch against the JAX model, which off the
  TPU runs its fp32 ``_fallback_conv`` whatever the switch: the head's
  input and the decoded boxes of the same proposals within 2e-2 of their
  largest value.
- The one-hot engine ignores the switch.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from msmdfusion_tpu.ops.sparse import matchconv as jmc

from msmdfusion_torch import kernels
from msmdfusion_torch.models.heads import transfusion_head
from msmdfusion_torch.ops.sparse import matchconv as tmc
from msmdfusion_torch.utils.convert import msmdfusion_rules
from tests.test_torch_msmdfusion import build_pair, make_batch, tiny_config
from tests.test_torch_onehot import (assert_close, jax_flagship,  # noqa: F401
                                     one_thread, port_flagship)
from tests.test_torch_sparse_ops import both_tensors, random_sparse
from tests.test_torch_train_ops import jax_plan, port_plan, strided

TOL = 1e-4
BF16_TOL = 2e-2


@pytest.fixture
def bf16(monkeypatch):
    monkeypatch.setenv('MSMD_CONV_DTYPE', 'bfloat16')


@pytest.mark.parametrize('k_cap,n_valid,shape,cin,cout', [
    (512, 400, (9, 24, 24), 16, 16), (256, 200, (5, 16, 16), 10, 8)])
def test_packed_conv_matches_pallas(k_cap, n_valid, shape, cin, cout, bf16):
    rng = np.random.RandomState(30)
    j, t = both_tensors(*random_sparse(rng, k_cap, n_valid, shape, cin),
                        shape)
    jplan = jmc.attach_rows(j.keys, jmc.build_subm_plan(j, 3, tile=128),
                            interpret=True)
    rows = tmc.attach_rows(t.keys, tmc.build_subm_plan(t, 3)).rows
    w = (rng.randn(27, cin, cout) * 0.1).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    shift = rng.uniform(-0.3, 0.3, cout).astype(np.float32)
    wt = torch.from_numpy(w)

    kernels.reset_launches()
    got = tmc.gather_gemm_conv(t.features, rows, wt)
    assert sum(kernels.launches.values()) == 0
    want = np.asarray(jmc._vgather_conv(j.features, jplan, jnp.asarray(w),
                                        interpret=True))[:k_cap]
    assert_close(got.numpy(), want)
    oracle = tmc._rows_product(t.features, rows, wt)       # fp32
    for out in (got.numpy(), want):
        assert_close(out, oracle.numpy(), tol=BF16_TOL)
    # bf16 moved the result: the operands really were rounded
    assert np.abs(got.numpy() - oracle.numpy()).max() > \
        1e-5 * np.abs(oracle.numpy()).max()

    epi = tmc.gather_gemm_conv(
        t.features, rows, wt, scale=torch.from_numpy(scale),
        shift=torch.from_numpy(shift), relu=True, out_valid=t.valid)
    want_epi = jmc._vgather_conv(
        j.features, jplan, jnp.asarray(w), interpret=True,
        scale=jnp.asarray(scale), shift=jnp.asarray(shift), relu=True,
        out_valid=jnp.asarray(t.valid.numpy()))
    assert_close(epi.numpy(), np.asarray(want_epi)[:k_cap])
    # the epilogue runs on the fp32 sum of the rounded operands
    assert_close(epi.numpy(), tmc.apply_epilogue(
        got, t.valid, torch.from_numpy(scale), torch.from_numpy(shift),
        True).numpy(), tol=1e-6)


def test_packed_backward_matches_pallas(bf16):
    rng = np.random.RandomState(31)
    conv = (3, 2, 1)
    j, t, jout, tout = strided(rng, *conv)
    jplan, plan = jax_plan(j, jout, conv), port_plan(t, tout, conv)
    cin, cout = 8, 12
    w = (rng.randn(27, cin, cout) * 0.1).astype(np.float32)
    g = rng.randn(jplan.inb.shape[0], cout).astype(np.float32)

    feats = t.features.clone().requires_grad_(True)
    weights = torch.from_numpy(w).requires_grad_(True)
    out = tmc.MatchConv.apply(feats, weights, plan)
    out.backward(torch.from_numpy(g[:plan.k_out]))
    d_feats, d_w = jmc._pallas_bwd(j.features, j.keys, jplan, jnp.asarray(w),
                                   jnp.asarray(g), 1024, None,
                                   interpret=True)
    assert_close(feats.grad.numpy(), d_feats, msg='d_feats')
    assert_close(weights.grad.numpy(), d_w, msg='dw')
    # against the fp32 backward: bf16-level, not equal
    fp32_feats, fp32_w = jmc._match_conv_bwd_xla(
        j.features, j.keys, jplan, jnp.asarray(w), jnp.asarray(g))
    assert_close(weights.grad.numpy(), fp32_w, tol=BF16_TOL)
    assert_close(feats.grad.numpy(), fp32_feats, tol=BF16_TOL)
    assert not np.allclose(weights.grad.numpy(), np.asarray(fp32_w),
                           rtol=1e-5, atol=1e-6)


def test_packed_dw_rounds_both_operands(bf16):
    rng = np.random.RandomState(32)
    feats = torch.from_numpy(rng.randn(50, 6).astype(np.float32))
    g = torch.from_numpy(rng.randn(40, 5).astype(np.float32))
    rows = torch.from_numpy(rng.randint(-1, 50, (40, 3)).astype(np.int32))
    got = tmc.conv_dw(feats, rows, g)
    for t in range(3):
        hit = rows[:, t] >= 0
        want = (tmc.bf16_round(feats)[rows[hit, t].long()].T.double()
                @ tmc.bf16_round(g)[hit].double())
        np.testing.assert_allclose(got[t].numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_onehot_engine_ignores_the_dtype(bf16, monkeypatch):
    rng = np.random.RandomState(33)
    _, t = both_tensors(*random_sparse(rng, 256, 200, (5, 16, 16), 8),
                        (5, 16, 16))
    plan = tmc.build_subm_plan(t, 3)
    w = torch.from_numpy((rng.randn(27, 8, 4) * 0.1).astype(np.float32))
    rows = tmc.plan_rows_plain(t.keys, plan)
    g = torch.from_numpy(rng.randn(256, 4).astype(np.float32))
    packed_dw = tmc.conv_dw(t.features, rows, g)
    monkeypatch.setenv('MSMD_CONV_ALGO', 'onehot')
    out = tmc.apply_match_conv(t, plan, w, t.coords, t.valid, t.keys,
                               t.spatial_shape, relu=True)
    want = torch.relu(tmc._rows_product(t.features, rows, w))
    assert torch.equal(out.features, torch.where(t.valid[:, None], want, 0.0))
    dw = tmc.conv_dw(t.features, rows, g)               # fp32 under one-hot
    monkeypatch.delenv('MSMD_CONV_DTYPE')
    assert torch.equal(dw, tmc.conv_dw(t.features, rows, g))
    assert not torch.equal(dw, packed_dw)


@pytest.fixture(scope='module')
def tiny():
    batch = make_batch(np.random.RandomState(0))
    jmodel, variables, port = build_pair(
        tiny_config(), batch, msmdfusion_rules(depth=18, layer_nums=(2, 2)))
    return port, batch, jax_flagship(jmodel, variables, batch)


def test_tiny_flagship_packed_matches_jax(tiny, monkeypatch):
    port, batch, (jx, jpreds, jboxes) = tiny
    # decode the JAX model's proposals (bf16 may swap a near-tie at the
    # cut): the port's fp32 choice, which is the JAX model's
    _, preds, _ = port_flagship(port, batch)
    np.testing.assert_array_equal(preds['query_labels'].numpy(),
                                  np.asarray(jpreds['query_labels']))
    h, w = preds['dense_heatmap'].shape[-2:]
    index = preds['query_labels'] * (h * w) + preds['query_spatial']
    monkeypatch.setattr(transfusion_head, 'topk_lower_index_first',
                        lambda x, k: (torch.gather(x, 1, index), index))
    monkeypatch.setenv('MSMD_CONV_DTYPE', 'bfloat16')
    calls = []

    def counting(*args, **kwargs):
        calls.append(tmc.packed())
        return tmc.gather_gemm_conv_plain(*args, **kwargs)
    monkeypatch.setattr(tmc, 'gather_gemm_conv', counting)
    x, preds, boxes = port_flagship(port, batch)
    assert calls == [True] * 37
    assert_close(x.numpy(), jx, tol=BF16_TOL, msg='head input')
    assert_close(boxes['bboxes'].numpy(), jboxes['bboxes'], tol=BF16_TOL,
                 msg='boxes')
    assert np.isfinite(boxes['bboxes'].numpy()).all()
    # bf16 moved the head input: the switch reached the convs
    assert np.abs(x.numpy() - np.asarray(jx)).max() > \
        1e-5 * np.abs(np.asarray(jx)).max()
