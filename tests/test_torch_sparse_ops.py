"""Port sparse ops vs the JAX package on the CPU.

The same numpy inputs go through the JAX functions and their counterparts
in ``msmdfusion_torch``. On the CPU the port's kernel wrappers run their
plain PyTorch versions; the JAX rulebook kernel (``_win_rows_kernel``) and
gather conv kernel (``_vgather_kernel``) run in Pallas interpret mode, as
``tests/test_matchconv.py`` runs them. Rows and coordinate sets must match
exactly; convolutions agree to 1e-4 (the Pallas conv's fp32 mode is a
three-pass bf16 hi/lo product, ~2^-17 relative).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from msmdfusion_tpu.ops.sparse import conv as jconv
from msmdfusion_tpu.ops.sparse import matchconv as jmc
from msmdfusion_tpu.ops.sparse import tensor as jtensor

from msmdfusion_torch import kernels
from msmdfusion_torch.ops.sparse import conv as tconv
from msmdfusion_torch.ops.sparse import matchconv as tmc
from msmdfusion_torch.ops.sparse import tensor as ttensor

INT_MAX = 2 ** 31 - 1
TOL = 1e-4


def random_sparse(rng, k_cap, n_valid, shape, c, batch_size=1):
    """Sorted unique coords of ``n_valid`` random cells, padded to k_cap."""
    z, y, x = shape
    coords = np.stack([rng.randint(0, batch_size, n_valid),
                       rng.randint(0, z, n_valid), rng.randint(0, y, n_valid),
                       rng.randint(0, x, n_valid)], 1).astype(np.int32)
    keys = ((coords[:, 0].astype(np.int64) * z + coords[:, 1]) * y
            + coords[:, 2]) * x + coords[:, 3]
    _, idx = np.unique(keys, return_index=True)
    coords = coords[idx]                    # np.unique sorts by key
    n = len(coords)
    pad = k_cap - n
    coords = np.concatenate([coords, np.full((pad, 4), -1, np.int32)])
    valid = np.arange(k_cap) < n
    feats = (rng.randn(k_cap, c) * valid[:, None]).astype(np.float32)
    return feats, coords, valid


def both_tensors(feats, coords, valid, shape, batch_size=1,
                 assume_sorted=True):
    j = jtensor.make_sparse_tensor(jnp.asarray(feats), jnp.asarray(coords),
                                   jnp.asarray(valid), shape, batch_size,
                                   assume_sorted=assume_sorted)
    t = ttensor.make_sparse_tensor(torch.from_numpy(feats),
                                   torch.from_numpy(coords),
                                   torch.from_numpy(valid), shape, batch_size,
                                   assume_sorted=assume_sorted)
    return j, t


def assert_same_tensor(j, t):
    np.testing.assert_array_equal(np.asarray(j.keys), t.keys.numpy())
    np.testing.assert_array_equal(np.asarray(j.coords), t.coords.numpy())
    np.testing.assert_array_equal(np.asarray(j.valid), t.valid.numpy())
    np.testing.assert_array_equal(np.asarray(j.features), t.features.numpy())


@pytest.mark.parametrize('batch_size', [1, 2])
def test_make_sparse_tensor_sorts_like_jax(batch_size):
    rng = np.random.RandomState(1)
    shape = (9, 24, 24)
    feats, coords, valid = random_sparse(rng, 300, 250, shape, 4, batch_size)
    perm = rng.permutation(len(valid))      # unsorted input rows
    j, t = both_tensors(feats[perm], coords[perm], valid[perm], shape,
                        batch_size, assume_sorted=False)
    assert_same_tensor(j, t)
    assert (t.keys[:-1] <= t.keys[1:]).all()
    js, ts = both_tensors(feats, coords, valid, shape, batch_size)
    assert_same_tensor(js, ts)
    np.testing.assert_array_equal(
        np.asarray(jtensor.unpack_keys(js.keys, shape))[valid],
        ttensor.unpack_keys(ts.keys, shape).numpy()[valid])


def test_make_sparse_tensor_capacity_keeps_smallest_keys_like_jax():
    from msmdfusion_torch.utils import overflow
    rng = np.random.RandomState(11)
    shape = (9, 24, 24)
    feats, coords, valid = random_sparse(rng, 300, 250, shape, 4, 2)
    perm = rng.permutation(len(valid))
    n_valid, cap = int(valid.sum()), int(valid.sum()) - 9
    j = jtensor.make_sparse_tensor(
        jnp.asarray(feats[perm]), jnp.asarray(coords[perm]),
        jnp.asarray(valid[perm]), shape, 2, capacity=cap, site='s')
    with overflow.capture() as c:
        t = ttensor.make_sparse_tensor(
            torch.from_numpy(feats[perm]), torch.from_numpy(coords[perm]),
            torch.from_numpy(valid[perm]), shape, 2, capacity=cap, site='s')
    assert_same_tensor(j, t)
    assert t.capacity == cap and bool(t.valid.all())
    assert c.counters() == {'sparse.make.capacity[s]': n_valid - cap}
    assert c.gauge_values() == {'occ.make[s]': [n_valid]}


def test_to_dense_bev_collapses_channels_like_jax():
    rng = np.random.RandomState(2)
    shape = (3, 8, 10)
    j, t = both_tensors(*random_sparse(rng, 120, 100, shape, 5, 2), shape, 2)
    np.testing.assert_array_equal(np.asarray(jtensor.to_dense_bev(j)),
                                  ttensor.to_dense_bev(t).numpy())


@pytest.mark.parametrize('kernel,stride,padding', [
    (3, 2, 1), (3, 2, (0, 1, 1)), ((3, 1, 1), (2, 1, 1), 0)])
def test_downsample_out_coords_exact(kernel, stride, padding):
    rng = np.random.RandomState(3)
    shape = (11, 24, 24)
    j, t = both_tensors(*random_sparse(rng, 400, 350, shape, 4, 2), shape, 2)
    jk, jc, jv, js = jconv.downsample_out_coords(j, kernel, stride, padding,
                                                 900)
    tk, tc, tv, ts = tconv.downsample_out_coords(t, kernel, stride, padding,
                                                 900)
    assert tuple(js) == tuple(ts)
    np.testing.assert_array_equal(np.asarray(jk), tk.numpy())
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())


def test_downsample_capacity_keeps_smallest_keys_and_counts():
    from msmdfusion_torch.utils import overflow
    rng = np.random.RandomState(4)
    shape = (11, 24, 24)
    _, t = both_tensors(*random_sparse(rng, 400, 350, shape, 4), shape)
    full, _, _, _ = tconv.downsample_out_coords(t, 3, 2, 1, 4000)
    n = int((full != INT_MAX).sum())
    with overflow.capture() as cap:
        cut, _, valid, _ = tconv.downsample_out_coords(t, 3, 2, 1, n - 7,
                                                       site='s')
    np.testing.assert_array_equal(cut.numpy(), full[:n - 7].numpy())
    assert bool(valid.all())
    assert cap.counters() == {'sparse.downsample.out_cap[s]': 7}


def _plans(rng, c=8):
    """(jax st, port st, [(name, jax plan, port plan)]): a subm plan and
    the stride-2 plan of a (9, 24, 24) coordinate set, tile 128."""
    shape = (9, 24, 24)
    j, t = both_tensors(*random_sparse(rng, 512, 400, shape, c), shape)
    plans = [('subm', jmc.build_subm_plan(j, 3, tile=128),
              tmc.build_subm_plan(t, 3))]
    jk, jc, jv, _ = jconv.downsample_out_coords(j, 3, 2, 1, 640)
    _, tc, tv, _ = tconv.downsample_out_coords(t, 3, 2, 1, 640)
    plans.append(('down', jmc.build_downsample_plan(j, jc, jv, 3, 2, 1,
                                                    tile=128),
                  tmc.build_downsample_plan(t, tc, tv, 3, 2, 1)))
    return j, t, plans


def test_rows_match_jax_oracle_and_pallas_kernel():
    rng = np.random.RandomState(5)
    j, t, plans = _plans(rng)
    for name, jp, tp in plans:
        k_out = tp.k_out
        got = tmc.rows_affine_plain(t.keys, tp.okeys, tp.dkey, tp.inb)
        assert got.shape == (k_out, tp.num_taps) and got.dtype == torch.int32
        oracle = np.asarray(jmc._rows_from_plan(j.keys, jp)).T[:k_out]
        np.testing.assert_array_equal(got.numpy(), oracle, err_msg=name)
        pallas = jmc.attach_rows(j.keys, jp, interpret=True)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(pallas.rows_raw)[:k_out], err_msg=name)
        assert (got >= 0).sum() > k_out, name     # real neighbours matched
        # the wrapper on CPU tensors is the plain version
        np.testing.assert_array_equal(
            tmc.attach_rows(t.keys, tp).rows.numpy(), oracle)


def test_plan_fields_match_jax():
    rng = np.random.RandomState(6)
    _, _, plans = _plans(rng)
    for name, jp, tp in plans:
        k_out = tp.k_out
        np.testing.assert_array_equal(np.asarray(jp.okeys)[:k_out],
                                      tp.okeys.numpy(), err_msg=name)
        np.testing.assert_array_equal(np.asarray(jp.dkey, np.int32),
                                      tp.dkey.numpy(), err_msg=name)
        np.testing.assert_array_equal(np.asarray(jp.inb)[:k_out],
                                      tp.inb.numpy(), err_msg=name)


def _conv_inputs(rng, cin, cout):
    j, t, plans = _plans(rng, cin)
    w = (rng.randn(27, cin, cout) * 0.2).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    shift = rng.uniform(-0.3, 0.3, cout).astype(np.float32)
    return j, t, plans, w, scale, shift


def _assert_close(got, want, msg=''):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=TOL,
                               atol=TOL * np.abs(want).max(), err_msg=msg)


@pytest.mark.parametrize('cin,cout', [(8, 16), (16, 16)])
def test_conv_matches_jax_fallback_and_pallas(cin, cout):
    rng = np.random.RandomState(7)
    j, t, plans, w, scale, shift = _conv_inputs(rng, cin, cout)
    for name, jp, tp in plans:
        k_out = tp.k_out
        rows = tmc.attach_rows(t.keys, tp).rows
        out_valid = tp.okeys != INT_MAX
        jv = jnp.asarray(out_valid.numpy())
        wt = torch.from_numpy(w)
        plain = tmc.gather_gemm_conv(t.features, rows, wt)
        fallback = jmc._fallback_conv(j.features, j.keys, jp, jnp.asarray(w))
        _assert_close(plain.numpy(), np.asarray(fallback)[:k_out], name)

        jpr = jmc.attach_rows(j.keys, jp, interpret=True)
        pallas = jmc._vgather_conv(j.features, jpr, jnp.asarray(w),
                                   interpret=True)
        _assert_close(plain.numpy(), np.asarray(pallas)[:k_out], name)

        epi = tmc.gather_gemm_conv(
            t.features, rows, wt, scale=torch.from_numpy(scale),
            shift=torch.from_numpy(shift), relu=True, out_valid=out_valid)
        want = jmc.apply_epilogue_xla(fallback[:k_out], jv, scale, shift,
                                      relu=True)
        _assert_close(epi.numpy(), want, name + ' epilogue')
        pallas_epi = jmc._vgather_conv(
            j.features, jpr, jnp.asarray(w), interpret=True,
            scale=jnp.asarray(scale), shift=jnp.asarray(shift), relu=True,
            out_valid=jv)
        _assert_close(epi.numpy(), np.asarray(pallas_epi)[:k_out],
                      name + ' pallas epilogue')
        assert (epi.numpy() > 0).any() and (epi.numpy() == 0).any()


def test_apply_match_conv_folds_bias_into_shift():
    rng = np.random.RandomState(8)
    _, t, plans, w, scale, shift = _conv_inputs(rng, 8, 16)
    _, _, tp = plans[0]
    tp = tmc.attach_rows(t.keys, tp)
    bias = torch.from_numpy(rng.randn(16).astype(np.float32))
    sc, sh = torch.from_numpy(scale), torch.from_numpy(shift)
    out = tmc.apply_match_conv(t, tp, torch.from_numpy(w), t.coords, t.valid,
                               t.keys, t.spatial_shape, bias=bias, scale=sc,
                               shift=sh, relu=True)
    raw = tmc.gather_gemm_conv_plain(t.features, tp.rows, torch.from_numpy(w))
    want = torch.where(t.valid[:, None],
                       torch.relu((raw + bias) * sc + sh), 0.0)
    _assert_close(out.features.numpy(), want.numpy())
    plain_bias = tmc.apply_match_conv(t, tp, torch.from_numpy(w), t.coords,
                                      t.valid, t.keys, t.spatial_shape,
                                      bias=bias)
    _assert_close(plain_bias.features.numpy(),
                  torch.where(t.valid[:, None], raw + bias, 0.0).numpy())


def test_wrappers_check_their_inputs():
    rng = np.random.RandomState(9)
    _, t, plans = _plans(rng)
    _, _, tp = plans[0]
    with pytest.raises(TypeError):
        tmc.rows_affine(t.keys.to(torch.int64), tp.okeys, tp.dkey, tp.inb)
    with pytest.raises(ValueError):
        tmc.rows_affine(t.keys, tp.okeys[:-1], tp.dkey, tp.inb)
    rows = tmc.attach_rows(t.keys, tp).rows
    w = torch.zeros(27, 8, 4)
    with pytest.raises(TypeError):
        tmc.gather_gemm_conv(t.features.double(), rows, w.double())
    with pytest.raises(ValueError):
        tmc.gather_gemm_conv(t.features, rows, w[:3])
    with pytest.raises(ValueError):
        tmc.gather_gemm_conv(t.features, rows.t(), w)   # not contiguous


def test_cpu_tensors_never_count_launches():
    rng = np.random.RandomState(10)
    _, t, plans = _plans(rng)
    _, _, tp = plans[0]
    kernels.reset_launches()
    rows = tmc.attach_rows(t.keys, tp).rows
    tmc.gather_gemm_conv(t.features, rows, torch.zeros(27, 8, 4))
    assert kernels.launches == {'rows_affine': 0, 'rows_queries': 0,
                                'gather_gemm_conv': 0,
                                'gather_gemm_conv_bf16': 0,
                                'gather_gemm_conv_x3': 0, 'conv_dw': 0,
                                'conv_dw_bf16': 0, 'conv_dw_x3': 0,
                                'match_conv': 0, 'match_conv_x3': 0,
                                'match_conv_bf16': 0, 'masked_nn': 0,
                                'merge_take': 0}
    assert not kernels.use_kernel(t.keys)
