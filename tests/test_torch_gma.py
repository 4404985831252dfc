"""Port GMA encoder vs the JAX package's, on the CPU.

Four stages of LiDAR voxels (two batches) on the tiny flagship's grids and
camera voxels that partly share their cells (mixed rows) and partly lie
beside them (orphans). ``modality_split`` and ``approx_nn_3d`` must be
equal; the whole ``SparseMultiModalEncoderPaint``, run on the LiDAR
voxels' own SubM plans as the detector hands it the encoder's, agrees to
1e-4 of the largest reference value, stage by stage.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from msmdfusion_tpu.models.middle_encoders import gma_encoder as jgma
from msmdfusion_tpu.ops.sparse import matchconv as jmc
from msmdfusion_tpu.ops.sparse import tensor as jtensor

from msmdfusion_torch.models import sparse_blocks
from msmdfusion_torch.models.middle_encoders import gma_encoder as tgma
from msmdfusion_torch.ops.sparse import matchconv as tmc
from msmdfusion_torch.ops.sparse import tensor as ttensor
from msmdfusion_torch.utils import overflow
from msmdfusion_torch.utils.convert import (from_jax_variables,
                                            msmdfusion_rules)
from tests.test_torch_transfusion_l import randomize

TOL = 1e-4
SHAPES = [(41, 64, 64), (21, 32, 32), (11, 16, 16), (5, 8, 8)]
C3 = (4, 8, 8, 8)
C2 = 16


def stage_sets(rng, shape, n3, n2_mixed, n2_orphan, c3, c2):
    """(3D set, 2D set) as (features, coords, valid) of sorted unique cells
    in two batches: the 2D set takes ``n2_mixed`` cells of the 3D set and
    ``n2_orphan`` cells within a few voxels of it; both are padded."""
    z, y, x = shape
    dims = np.array([2, z, y, x])
    c = np.stack([rng.randint(0, d, n3) for d in dims], 1)
    key = ((c[:, 0] * z + c[:, 1]) * y + c[:, 2]) * x + c[:, 3]
    _, first = np.unique(key, return_index=True)
    c3_cells = c[first]
    near = c3_cells[rng.randint(0, len(c3_cells), n2_orphan)].copy()
    near[:, 1:] += rng.randint(-3, 4, (n2_orphan, 3))
    near[:, 1:] = np.clip(near[:, 1:], 0, dims[1:] - 1)
    c2_cells = np.concatenate([
        c3_cells[rng.choice(len(c3_cells), n2_mixed, replace=False)], near])

    def pack(cells, c):
        key = ((cells[:, 0] * z + cells[:, 1]) * y + cells[:, 2]) * x + \
            cells[:, 3]
        _, first = np.unique(key, return_index=True)
        cells = cells[first].astype(np.int32)
        cap = 2 * len(cells) + 7
        coords = np.concatenate([cells, np.full((cap - len(cells), 4), -1,
                                                np.int32)])
        valid = np.arange(cap) < len(cells)
        feats = (rng.randn(cap, c) * valid[:, None]).astype(np.float32)
        return feats, coords, valid
    return pack(c3_cells, c3), pack(c2_cells, c2)


def both(feats, coords, valid, shape):
    j = jtensor.make_sparse_tensor(jnp.asarray(feats), jnp.asarray(coords),
                                   jnp.asarray(valid), shape, 2,
                                   assume_sorted=True)
    t = ttensor.make_sparse_tensor(torch.from_numpy(feats),
                                   torch.from_numpy(coords),
                                   torch.from_numpy(valid), shape, 2,
                                   assume_sorted=True)
    return j, t


@pytest.fixture(scope='module')
def stages():
    rng = np.random.RandomState(0)
    out = []
    for shape, n3, c3 in zip(SHAPES, (1500, 800, 300, 100), C3):
        s3, s2 = stage_sets(rng, shape, n3, n3 // 6, n3 // 8, c3, C2)
        out.append((both(*s3, shape), both(*s2, shape)))
    return out


def test_modality_split_matches_jax(stages):
    for (j3, t3), (j2, t2) in stages:
        want = jax.jit(jgma.modality_split)(j3, j2)
        got = tgma.modality_split(t3, t2)
        assert set(got) == set(want)
        for key, value in want.items():
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(value),
                                          key)
        assert got['mix_3d'].any() and got['only_2d'].any()


@pytest.mark.parametrize('num_reps,radius,thresh', [(16, 6.0, 13.3),
                                                    (64, 2.0, 1.6)])
def test_approx_nn_3d_matches_jax(stages, num_reps, radius, thresh):
    assigned = 0
    for (j3, t3), (j2, t2) in stages:
        only_2d = tgma.modality_split(t3, t2)['only_2d']
        want = jax.jit(jgma.approx_nn_3d, static_argnums=(4, 5, 6))(
            j2.coords, jnp.asarray(only_2d.numpy()), j3.coords, j3.valid,
            num_reps, radius, thresh)
        got = tgma.approx_nn_3d(t2.coords, only_2d, t3.coords, t3.valid,
                                num_reps, radius, thresh)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assigned += int((got >= 0).sum())
    assert assigned > 0


def gma_outputs(stages, monkeypatch):
    """(port stage outputs, JAX stage outputs, the sites that built rows)
    of the whole encoder on seeded random JAX variables, run on the LiDAR
    voxels' own SubM plans as the detector hands it the encoder's."""
    v3j = [s[0][0] for s in stages]
    v3t = [s[0][1] for s in stages]
    v2j = [s[1][0] for s in stages]
    v2t = [s[1][1] for s in stages]
    plans_j = [jmc.build_subm_plan(j, 3) for j in v3j]
    plans_t = [tmc.attach_rows(t.keys, tmc.build_subm_plan(t, 3))
               for t in v3t]
    lists = dict(fps_num_list=[16] * 4, radius_list=[6, 3, 2, 1],
                 max_cluster_samples_list=[8] * 4,
                 dist_thresh_list=[13.3, 6.6, 3.3, 1.6])
    # downscale capacities of whole grids: random stage sets do not nest
    # as an encoder's do, and nothing may be dropped here
    caps = [2 * z * y * x for z, y, x in SHAPES[1:]] + [2 * 2 * 8 * 8]
    kw = dict(in_channels_3D=C3, in_channels_2D=(C2,) * 4,
              out_channels=(8, 8, 8, 8), padding=(1, 1, (0, 1, 1), 0),
              stage_capacities=caps)
    jenc = jgma.SparseMultiModalEncoderPaint(**kw)

    def run(v):
        return jenc.apply(v, v3j, v2j, shared_plans=plans_j,
                          **lists)
    shapes = jax.eval_shape(lambda: jenc.init(
        jax.random.PRNGKey(0), v3j, v2j, shared_plans=plans_j, **lists))
    variables = randomize(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), dict(shapes)),
        np.random.RandomState(1))
    want = jax.jit(run)(variables)

    prefix = 'multimodal_middle_encoder.'
    rules = [(t[len(prefix):], f.split('/', 1)[1], kind, ks)
             for t, f, kind, ks in msmdfusion_rules()
             if t.startswith(prefix)]
    port = tgma.SparseMultiModalEncoderPaint(**kw).eval()
    port.load_state_dict(from_jax_variables(variables, rules))
    built = []

    def counting(*args, **kwargs):
        built.append(kwargs.get('site', ''))
        return tmc.attach_rows(*args, **kwargs)
    monkeypatch.setattr(sparse_blocks, 'attach_rows', counting)
    with torch.no_grad(), overflow.capture() as cap:
        got = port(v3t, v2t, shared_plans=plans_t, **lists)
    assert cap.total() == 0, cap.counters()
    return got, want, built


def assert_stages_close(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.keys.numpy(), np.asarray(w.keys))
        np.testing.assert_array_equal(g.coords.numpy(), np.asarray(w.coords))
        want_f = np.asarray(w.features)
        np.testing.assert_allclose(g.features.numpy(), want_f, rtol=TOL,
                                   atol=TOL * np.abs(want_f).max(),
                                   err_msg=f'stage {i}')
        assert np.abs(want_f).max() > 0


def test_gma_encoder_with_shared_plans_matches_jax(stages, monkeypatch):
    got, want, built = gma_outputs(stages, monkeypatch)
    # the grouped convs ran on the shared plans: only the aggregation and
    # downscale coordinate sets built rows
    assert sorted(built) == sorted([f'agg_{i}' for i in range(1, 5)]
                                   + [f'spconv_ds_{i}' for i in range(1, 5)])
    assert_stages_close(got, want)
