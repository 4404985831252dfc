"""The JAX package's result-changing switches, as the port reads them, on
the CPU.

``MSMD_GMA_NN`` and ``MSMD_GMA_DUMMY`` (read by the GMA encoder per
stage), ``MSMD_FUSE_BN`` (read by the sparse conv blocks in eval mode) and
``MSMD_SPARSE_BACKEND`` (read by every kernel wrapper): under the value
that selects another path in the JAX package the port runs that path, and
its result departs from the default's as the JAX package's does
(``DEPARTS``; ``tests/test_torch_gma_ablations.py`` holds each path to the
JAX package's under the same switch). Set to their defaults, or to
another spelling the JAX package reads as the default, they run exactly
as when they are unset.
"""
import numpy as np
import pytest
import torch

from msmdfusion_torch.models.middle_encoders import gma_encoder as tgma
from msmdfusion_torch.models.sparse_blocks import (SparseBasicBlock,
                                                   SparseConvBlock,
                                                   SubMConv3d)
from msmdfusion_torch.ops.sparse import tensor as ttensor
from msmdfusion_torch.ops.sparse.merge_take import merge_take_rows
from tests.test_torch_gma import C2, C3, SHAPES, stage_sets


def port_sets(seed=0):
    """The four GMA stages' (3D, 2D) sparse tensors of
    ``test_torch_gma.py``, port side only."""
    rng = np.random.RandomState(seed)
    out = []
    for shape, n3, c3 in zip(SHAPES, (1500, 800, 300, 100), C3):
        sets = stage_sets(rng, shape, n3, n3 // 6, n3 // 8, c3, C2)
        out.append([ttensor.make_sparse_tensor(
            *(torch.from_numpy(a) for a in s), shape, 2, assume_sorted=True)
            for s in sets])
    return out


def gma_forward():
    torch.manual_seed(0)
    sets = port_sets()
    caps = [2 * z * y * x for z, y, x in SHAPES[1:]] + [2 * 2 * 8 * 8]
    enc = tgma.SparseMultiModalEncoderPaint(
        in_channels_3D=C3, in_channels_2D=(C2,) * 4,
        out_channels=(8, 8, 8, 8), padding=(1, 1, (0, 1, 1), 0),
        stage_capacities=caps).eval()
    with torch.no_grad():
        outs = enc([s[0] for s in sets], [s[1] for s in sets],
                   fps_num_list=[16] * 4, radius_list=[6, 3, 2, 1],
                   max_cluster_samples_list=[8] * 4,
                   dist_thresh_list=[13.3, 6.6, 3.3, 1.6])
    return [o.features for o in outs]


def blocks_forward():
    """A conv block and a basic block with seeded, non-trivial norms (the
    default statistics fold to a scale of rsqrt(1 + eps) and no shift, on
    which the folded and the unfused arithmetic agree bit for bit)."""
    torch.manual_seed(0)
    st = port_sets()[0][0]
    conv = SparseConvBlock(C3[0], 8, 3, indice_key='a').eval()
    block = SparseBasicBlock(8, indice_key='a').eval()
    with torch.no_grad():
        for bn in (conv[1], block.bn1, block.bn2):
            bn.weight.uniform_(0.5, 1.5)
            bn.bias.uniform_(-0.5, 0.5)
            bn.running_mean.uniform_(-0.5, 0.5)
            bn.running_var.uniform_(0.5, 2.0)
        st, cache = conv(st, {})
        return [block(st, cache)[0].features]


def backend_forward():
    torch.manual_seed(0)
    st = port_sets()[0][0]
    conv = SubMConv3d(C3[0], 8, 3, indice_key='a')
    idx = torch.arange(st.capacity, dtype=torch.int32).flip(0)
    with torch.no_grad():
        return [conv(st, {})[0].features, merge_take_rows(st.features, idx)]


# each switch, its JAX default, one value the JAX package reads as another
# path, one other spelling it reads as the default's path, and the port's
# entry points that read it
SWITCHES = [('MSMD_GMA_NN', 'approx', 'exact', 'approx2', gma_forward),
            ('MSMD_GMA_DUMMY', 'learned', 'random:0', 'learnt',
             gma_forward),
            ('MSMD_FUSE_BN', '1', '0', 'true', blocks_forward),
            ('MSMD_SPARSE_BACKEND', 'auto', 'xla', 'pallas',
             backend_forward)]
# how the other path's result departs from the default's in the JAX
# package on the CPU: another nearest voxel or dummy row ('differs'); the
# same arithmetic reassociated, the folded affine against the norm's own
# (matchconv.py:106-114: 'rounding', within 1e-5 of the largest value but
# not bit-equal); the XLA path, which is the JAX package's default off the
# TPU ('equal')
DEPARTS = {'MSMD_GMA_NN': 'differs', 'MSMD_GMA_DUMMY': 'differs',
           'MSMD_FUSE_BN': 'rounding', 'MSMD_SPARSE_BACKEND': 'equal'}


@pytest.fixture(scope='module')
def unset_outputs():
    """Each entry point's outputs with every switch unset, computed once:
    {forward: outputs}."""
    cache = {}

    def outputs(forward):
        if forward not in cache:
            with pytest.MonkeyPatch.context() as mp:
                for name, *_ in SWITCHES:
                    mp.delenv(name, raising=False)
                cache[forward] = forward()
        return cache[forward]
    return outputs


def departure(got, want):
    """Largest |got - want| over the largest |want|, over the outputs."""
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    return err / max(float(w.abs().max()) for w in want)


@pytest.mark.parametrize('name,default,value,same,forward', SWITCHES,
                         ids=[s[0] for s in SWITCHES])
@pytest.mark.parametrize('at_default', [False, True, 'equivalent'],
                         ids=['other', 'default', 'equivalent'])
def test_switch_runs_its_path_or_runs_as_unset(name, default, value, same,
                                               forward, at_default,
                                               unset_outputs, monkeypatch):
    unset = unset_outputs(forward)
    assert any(bool(w.abs().sum() > 0) for w in unset)
    if at_default:
        monkeypatch.setenv(name, default if at_default is True else same)
        for got, want in zip(forward(), unset):
            assert torch.equal(got, want)
        return
    monkeypatch.setenv(name, value)
    got = forward()
    assert [g.shape for g in got] == [w.shape for w in unset]
    assert all(bool(torch.isfinite(g).all()) for g in got)
    rel = departure(got, unset)
    if DEPARTS[name] == 'differs':
        assert rel > 1e-3, rel
    elif DEPARTS[name] == 'rounding':
        assert 0 < rel <= 1e-5, rel
    else:
        assert rel == 0, rel
