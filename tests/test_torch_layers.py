"""Port layers and head helpers vs the JAX package on the CPU.

Masked batch norm (eval and its epilogue fold), ConvModule, the heatmap
local-maximum NMS, the top-k tie order and the box decode, on the same
numpy inputs and parameters. Elementwise paths agree to 1e-6; the conv to
1e-5 of the largest value (another summation order); tie orders and
masks exactly.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from msmdfusion_tpu.core.coders import TransFusionBBoxCoder as JaxCoder
from msmdfusion_tpu.models import layers as jlayers
from msmdfusion_tpu.models.heads.transfusion_head import _local_maximum_nms

from msmdfusion_torch.core.coders import TransFusionBBoxCoder
from msmdfusion_torch.models import layers as tlayers
from msmdfusion_torch.models.heads.transfusion_head import (
    local_maximum_nms, topk_lower_index_first)


def bn_params(rng, c):
    return dict(scale=rng.uniform(0.5, 1.5, c), bias=rng.randn(c) * 0.1,
                mean=rng.randn(c) * 0.1, var=rng.uniform(0.5, 1.5, c))


def load_bn(bn, p):
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(p['scale']))
        bn.bias.copy_(torch.from_numpy(p['bias']))
        bn.running_mean.copy_(torch.from_numpy(p['mean']))
        bn.running_var.copy_(torch.from_numpy(p['var']))
    return bn.eval()


def bn_variables(p):
    f = {k: jnp.asarray(v, jnp.float32) for k, v in p.items()}
    return {'params': {'scale': f['scale'], 'bias': f['bias']},
            'batch_stats': {'mean': f['mean'], 'var': f['var']}}


def test_masked_batch_norm_and_fold_match_jax():
    rng = np.random.RandomState(0)
    c, eps = 12, 1e-3
    p = bn_params(rng, c)
    x = rng.randn(50, c).astype(np.float32)
    mask = rng.rand(50) < 0.7
    jbn = jlayers.MaskedBatchNorm(eps=eps)
    want = jbn.apply(bn_variables(p), jnp.asarray(x), jnp.asarray(mask))
    js, jb = jbn.apply(bn_variables(p), jnp.asarray(x), fold=True)
    tbn = load_bn(tlayers.MaskedBatchNorm(c, eps=eps), p)
    with torch.no_grad():
        got = tbn(torch.from_numpy(x), mask=torch.from_numpy(mask))
        s, b = tbn.fold()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    assert (got.numpy()[~mask] == 0).all()
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-6,
                               atol=1e-7)
    tbn.train()
    with pytest.raises(ValueError, match='eval-mode'):
        tbn.fold()


@pytest.mark.parametrize('stride,padding,bias', [(1, 1, True), (2, 1, False)])
def test_conv_module_matches_jax(stride, padding, bias):
    rng = np.random.RandomState(1)
    cin, cout = 6, 8
    x = rng.randn(2, 10, 12, cin).astype(np.float32)          # NHWC
    kernel = (rng.randn(3, 3, cin, cout) * 0.2).astype(np.float32)
    b = (rng.randn(cout) * 0.1).astype(np.float32)
    p = bn_params(rng, cout)
    jm = jlayers.ConvModule(cout, 3, strides=stride, padding=padding,
                            use_bias=bias)
    conv = {'kernel': jnp.asarray(kernel)}
    if bias:
        conv['bias'] = jnp.asarray(b)
    bnv = bn_variables(p)
    want = jm.apply({'params': {'Conv_0': conv,
                                'MaskedBatchNorm_0': bnv['params']},
                     'batch_stats': {'MaskedBatchNorm_0':
                                     bnv['batch_stats']}}, jnp.asarray(x))
    tm = tlayers.ConvModule(cin, cout, 3, stride=stride, padding=padding,
                            bias=bias)
    with torch.no_grad():
        tm.conv.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
        if bias:
            tm.conv.bias.copy_(torch.from_numpy(b))
    load_bn(tm.bn, p)
    tm.eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    want = np.asarray(want)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize('kernel,flat', [(3, (8, 9)), (3, ()), (1, (8, 9))])
def test_local_maximum_nms_matches_jax(kernel, flat):
    rng = np.random.RandomState(2)
    # coarse levels so that neighbours tie and plateaus form
    hm = (rng.randint(0, 6, (2, 10, 9, 11)) / 5.0).astype(np.float32)
    want = _local_maximum_nms(jnp.asarray(hm.transpose(0, 2, 3, 1)), kernel,
                              flat)
    got = local_maximum_nms(torch.from_numpy(hm), kernel, flat)
    np.testing.assert_array_equal(got.numpy().transpose(0, 2, 3, 1),
                                  np.asarray(want))
    if kernel > 1:
        kept = got.numpy()
        other = [c for c in range(10) if c not in flat]
        # borders of non-flat classes survive only where they are 0
        assert (kept[:, other, 0, :] == 0).all()
        assert (kept[:, other, :, -1] == 0).all()


def test_topk_breaks_ties_like_jax():
    rng = np.random.RandomState(3)
    x = (rng.randint(0, 4, (3, 500)) / 3.0).astype(np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 40)
    tv, ti = topk_lower_index_first(torch.from_numpy(x), 40)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize('with_vel', [True, False])
def test_bbox_decode_matches_jax(with_vel):
    rng = np.random.RandomState(4)
    kw = dict(pc_range=[-54.0, -54.0], out_size_factor=8,
              voxel_size=[0.075, 0.075],
              post_center_range=[-61.2, -61.2, -10.0, 61.2, 61.2, 10.0],
              score_threshold=0.3, code_size=10)
    b, p = 2, 30
    args = [rng.rand(b, 10, p), rng.randn(b, 2, p), rng.randn(b, 3, p) * 0.5,
            rng.uniform(-30, 210, (b, 2, p)), rng.randn(b, 1, p)]
    if with_vel:
        args.append(rng.randn(b, 2, p))
    args = [a.astype(np.float32) for a in args]
    want = JaxCoder(**kw).decode(*map(jnp.asarray, args), filter=True)
    got = TransFusionBBoxCoder(**kw).decode(*map(torch.from_numpy, args),
                                            filter=True)
    np.testing.assert_allclose(got['bboxes'].numpy(),
                               np.asarray(want['bboxes']), rtol=1e-6,
                               atol=1e-5)
    for key in ('scores', 'labels', 'valid'):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), key)
    assert 0 < got['valid'].sum() < b * p
