"""The one-hot engine's conv (``match_conv``) on its two tensor-core
products vs the JAX package on the CPU.

On the card ``match_conv`` takes fp32 features on the x3 product by
default (kernel ``match_conv_x3``: both operands split into bf16 hi + lo,
hi.hi + hi.lo + lo.hi with fp32 sums), the exact one under
``MSMD_CONV_GEMM=highest`` (kernel ``match_conv``), and bf16 features
against the weights' hi and lo (kernel ``match_conv_bf16``, bf16 out:
the JAX kernel ``_match_kernel``'s ``parts=1`` mode). A CPU tensor takes
the plain version: the exact product for fp32, the bf16 kernel's for bf16.
The JAX one-hot kernel runs in Pallas interpret mode through
``_pallas_conv``, as its tests run it; at these sizes it applies the
weights as one ``HIGHEST`` GEMM to its hi/lo gather (~2^-16).

- ``match_conv_plain(..., gemm='x3')`` against ``_pallas_conv`` on subm,
  strided and dual (explicit-query) plans, with and without the fused
  epilogue, to 1e-4 of the largest value;
- the bf16 plain version against ``_pallas_conv`` on bf16 features on the
  same plans, each element within one bf16 ulp plus 2^-16 of the
  magnitude of its sum (all but a few within the ulp alone: the two
  weight products part by ~2^-17 of the magnitude where the terms
  cancel);
- the wrapper on CPU tensors runs those plain versions and counts no
  launch, and raises on the dtypes it does not take; on a stand-in card
  it launches each route's kernel with its C signature, forward and
  training backward (the input gradient over the transpose plan on the
  same kernel, the one-hot weight gradient exact).
"""
import contextlib
import types

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from msmdfusion_tpu.ops.sparse import matchconv as jmc

from chip_smoke import bf16_ulp
from msmdfusion_torch import kernels
from msmdfusion_torch.ops.sparse import matchconv as tmc
from tests.test_torch_onehot import INT_MAX, rowless_plans
from tests.test_torch_train_ops import STRIDED, strided

TOL = 1e-4
BF16_SUM_TOL = 2.0 ** -16   # of each sum's magnitude, beside one bf16 ulp
CASES = [('subm', 'forward'), (STRIDED[0], 'forward'),
         (STRIDED[1], 'forward'), (STRIDED[0], 'dual'), (STRIDED[1], 'dual')]
SWITCHES = ('MSMD_CONV_GEMM', 'MSMD_CONV_DTYPE', 'MSMD_CONV_ALGO')


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """One intra-op thread: the test files run in several worker
    processes that share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def set_env(monkeypatch, env):
    for k in SWITCHES:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


def conv_case(conv, plan_kind, seed=80):
    """(JAX plan, port plan, in_keys, feats, weights, epilogue) of a plan
    of ``CASES`` at 8 -> 12 channels (numpy inputs; epilogue: scale,
    shift and out_valid)."""
    rng = np.random.RandomState(seed)
    ks, stride, pad = (3, 1, 1) if conv == 'subm' else conv
    j, t, jout, tout = strided(rng, ks, stride, pad)
    jplan, tplan = rowless_plans(j, t, jout, tout, conv)
    cin, cout = 8, 12
    if plan_kind == 'dual':
        jplan, tplan = jplan.dual, tplan.dual
        keys = tout[0]
        feats = (rng.randn(keys.shape[0], cin) *
                 (keys != INT_MAX).numpy()[:, None]).astype(np.float32)
        out_valid = t.valid
    else:
        keys, feats = t.keys, t.features.numpy()
        out_valid = t.valid if conv == 'subm' else tout[2]
    w = (rng.randn(tplan.num_taps, cin, cout) * 0.2).astype(np.float32)
    epi = dict(scale=rng.uniform(0.5, 1.5, cout).astype(np.float32),
               shift=rng.uniform(-0.3, 0.3, cout).astype(np.float32),
               out_valid=out_valid.numpy())
    return jplan, tplan, keys, feats, w, epi


def both_calls(jplan, tplan, keys, feats, w, epi, with_epilogue, dtype):
    """(port plain version, JAX ``_pallas_conv`` in interpret mode) of one
    call, the features in ``dtype`` on both sides, numpy fp32."""
    tf = torch.from_numpy(feats).to(dtype)
    jf = jnp.asarray(feats).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                   else jnp.float32)
    jk = jnp.asarray(keys.numpy())
    tkw, jkw = {}, {}
    if with_epilogue:
        tkw = dict(scale=torch.from_numpy(epi['scale']),
                   shift=torch.from_numpy(epi['shift']), relu=True,
                   out_valid=torch.from_numpy(epi['out_valid']))
        jkw = dict(scale=jnp.asarray(epi['scale']),
                   shift=jnp.asarray(epi['shift']), relu=True,
                   out_valid=jnp.asarray(epi['out_valid']))
    got = tmc.match_conv_plain(tf, keys, tplan, torch.from_numpy(w),
                               gemm='x3', **tkw)
    want = jmc._pallas_conv(jf, jk, jplan, jnp.asarray(w), interpret=True,
                            **jkw)
    assert got.dtype == dtype and want.dtype == jf.dtype
    return (got.to(torch.float32).numpy(),
            np.asarray(want.astype(jnp.float32))[:tplan.k_out])


@pytest.mark.parametrize('with_epilogue', [False, True])
@pytest.mark.parametrize('conv,plan_kind', CASES)
def test_x3_plain_matches_pallas_conv(conv, plan_kind, with_epilogue):
    case = conv_case(conv, plan_kind)
    got, want = both_calls(*case, with_epilogue, torch.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * np.abs(want).max())
    tplan, keys = case[1], case[2]
    assert (tmc.plan_rows_plain(keys, tplan) >= 0).sum() > 200
    if with_epilogue:
        assert (got > 0).any() and (got == 0).any()
    # the x3 product, not the exact one: ~2^-17 of each sum apart
    exact = tmc.match_conv_plain(torch.from_numpy(case[3]), keys, tplan,
                                 torch.from_numpy(case[4])).numpy()
    if not with_epilogue:
        assert 0 < np.abs(got - exact).max() <= 2.0 ** -14 * np.abs(
            exact).max()


@pytest.mark.parametrize('with_epilogue', [False, True])
@pytest.mark.parametrize('conv,plan_kind', CASES)
def test_bf16_plain_matches_pallas_conv(conv, plan_kind, with_epilogue):
    case = conv_case(conv, plan_kind, seed=81)
    got, want = both_calls(*case, with_epilogue, torch.bfloat16)
    _, tplan, keys, feats, w, epi = case
    # each sum's magnitude: where its terms cancel, the two products (the
    # JAX kernel's HIGHEST one, the two passes' W_hi + W_lo) part by up to
    # ~2^-17 of it, which a small result's bf16 ulp need not cover
    f = torch.from_numpy(feats).to(torch.bfloat16).float().abs()
    mag = tmc.match_conv_plain(f, keys, tplan,
                               torch.from_numpy(np.abs(w))).numpy()
    if with_epilogue:
        mag = mag * np.abs(epi['scale']) + np.abs(epi['shift'])
    diff = np.abs(got - want)
    ulp = bf16_ulp(torch.tensor(want)).numpy()
    assert (diff <= ulp + BF16_SUM_TOL * mag).all()
    assert (diff <= ulp).mean() > 0.999
    assert (got != 0).sum() > 100


def small_call(seed):
    """(feats, in_keys, plan, weights, epilogue) of a subm call, torch."""
    _, plan, keys, feats, w, epi = conv_case('subm', 'forward', seed=seed)
    return (torch.from_numpy(feats), keys, plan, torch.from_numpy(w),
            dict(scale=torch.from_numpy(epi['scale']),
                 shift=torch.from_numpy(epi['shift']), relu=True,
                 out_valid=torch.from_numpy(epi['out_valid'])))


@pytest.mark.parametrize('env', [{}, {'MSMD_CONV_GEMM': 'highest'}])
def test_cpu_tensors_take_the_plain_versions(env, monkeypatch):
    set_env(monkeypatch, env)
    feats, keys, plan, w, epi = small_call(82)
    kernels.reset_launches()
    for kw in ({}, epi):
        assert torch.equal(tmc.match_conv(feats, keys, plan, w, **kw),
                           tmc.match_conv_plain(feats, keys, plan, w,
                                                gemm='exact', **kw))
        half = feats.to(torch.bfloat16)
        out = tmc.match_conv(half, keys, plan, w, **kw)
        assert out.dtype == torch.bfloat16
        assert torch.equal(out, tmc.match_conv_plain(half, keys, plan, w,
                                                     **kw))
    assert not any(kernels.launches.values())


def test_bf16_plain_is_two_weight_passes_rounded_once():
    feats, keys, plan, w, epi = small_call(83)
    half = feats.to(torch.bfloat16)
    rows = tmc.plan_rows_plain(keys, plan)
    w_hi, w_lo = tmc.split_hi_lo(w)
    f = half.float()
    want = tmc.apply_epilogue(
        tmc._rows_product(f, rows, w_hi) + tmc._rows_product(f, rows, w_lo),
        **epi)
    got = tmc.match_conv_plain(half, keys, plan, w, **epi)
    # the same two passes in another order of the fp32 sums
    assert (np.abs(got.float().numpy() - want.numpy()) <=
            bf16_ulp(want).numpy()).all()
    # x3 of bf16 features is those two passes (lo(f) is 0)
    assert torch.allclose(
        tmc.match_conv_plain(f, keys, plan, w, gemm='x3'),
        tmc._rows_product(f, rows, w_hi) + tmc._rows_product(f, rows, w_lo),
        rtol=0, atol=1e-6)


def test_wrapper_rejects_what_it_does_not_take():
    feats, keys, plan, w, _ = small_call(84)
    with pytest.raises(TypeError, match='weights'):
        tmc.match_conv(feats.to(torch.bfloat16), keys, plan,
                       w.to(torch.bfloat16))
    with pytest.raises(TypeError, match='float16'):
        tmc.match_conv(feats.to(torch.float16), keys, plan, w)
    with pytest.raises(TypeError, match='float16'):
        tmc.match_kernel(torch.float16)
    with pytest.raises(ValueError, match='gemm'):
        tmc.match_conv_plain(feats.to(torch.bfloat16), keys, plan, w,
                             gemm='fast')


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers as on the card, each kernel's C entry point stood in
    for by a recorder: [(kernel, its arguments)]."""
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


@pytest.mark.parametrize('env,dtype,kernel', [
    ({}, torch.float32, 'match_conv_x3'),
    ({'MSMD_CONV_GEMM': 'x3'}, torch.float32, 'match_conv_x3'),
    ({'MSMD_CONV_GEMM': 'highest'}, torch.float32, 'match_conv'),
    ({}, torch.bfloat16, 'match_conv_bf16'),
    ({'MSMD_CONV_GEMM': 'highest'}, torch.bfloat16, 'match_conv_bf16'),
    ({'MSMD_CONV_DTYPE': 'bfloat16'}, torch.float32, 'match_conv_x3')])
def test_wrapper_launches_the_routes_kernel(env, dtype, kernel, fake_card,
                                            monkeypatch):
    set_env(monkeypatch, env)
    feats, keys, plan, w, epi = small_call(85)
    out = tmc.match_conv(feats.to(dtype), keys, plan, w, **epi)
    assert out.dtype == dtype and out.shape == (plan.k_out, 12)
    assert tmc.match_kernel(dtype) == kernel
    (name, args), = fake_card
    assert name == kernel
    assert len(args) == len(kernels.ENTRY_POINTS[name][2])
    assert {k: v for k, v in kernels.launches.items() if v} == {kernel: 1}
    if kernel != 'match_conv':
        # weights split once per call into the packed layout
        hi, lo, np_, kc = tmc.x3_weights(w)
        assert args[12:16] == (np_, kc, hi.shape[2], 12) == (16, 16, 16, 12)


@pytest.mark.parametrize('env,kernel', [
    ({'MSMD_CONV_ALGO': 'onehot'}, 'match_conv_x3'),
    ({'MSMD_CONV_ALGO': 'onehot', 'MSMD_CONV_GEMM': 'highest'},
     'match_conv')])
@pytest.mark.parametrize('conv', ['subm', STRIDED[0]])
def test_onehot_training_launches(env, kernel, conv, fake_card,
                                  monkeypatch):
    """The forward and the input gradient (over the transpose plan, the
    dual's explicit queries for a strided conv) on the route's kernel;
    the weight gradient's rows built per conv and its product exact."""
    set_env(monkeypatch, env)
    rng = np.random.RandomState(86)
    ks, stride, pad = (3, 1, 1) if conv == 'subm' else conv
    j, t, jout, tout = strided(rng, ks, stride, pad)
    _, plan = rowless_plans(j, t, jout, tout, conv)
    feats = t.features.clone().requires_grad_(True)
    w = torch.randn(plan.num_taps, 8, 6, requires_grad=True)
    out = tmc.MatchConv.apply(feats, w, plan, t.keys)
    out.backward(torch.ones_like(out))
    assert [name for name, _ in fake_card] == [kernel, kernel, 'rows_affine',
                                               'conv_dw']
    dual = fake_card[1][1]
    assert (dual[6] is not None) == (conv != 'subm')   # queries
