"""The JAX package's result-changing switches that the port does not run
yet, on the CPU.

``MSMD_GMA_NN`` and ``MSMD_GMA_DUMMY`` (read by the GMA encoder per
stage), ``MSMD_FUSE_BN`` (read by the sparse conv blocks in eval mode) and
``MSMD_SPARSE_BACKEND`` (read by every sparse conv and by
``merge_take_rows``): under a value that selects another path in the JAX
package the port raises a ``ValueError`` that names the switch, where the
JAX package reads it, instead of silently computing the default's result.
Set to their defaults, or to another spelling the JAX package reads as
the default, they run exactly as when they are unset.
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
from msmdfusion_torch.utils.switches import UNPORTED
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
    torch.manual_seed(0)
    st = port_sets()[0][0]
    conv = SparseConvBlock(C3[0], 8, 3, indice_key='a').eval()
    block = SparseBasicBlock(8, indice_key='a').eval()
    with torch.no_grad():
        st, cache = conv(st, {})
        return [block(st, cache)[0].features]


def backend_forward():
    torch.manual_seed(0)
    st = port_sets()[0][0]
    conv = SubMConv3d(C3[0], 8, 3, indice_key='a')
    idx = torch.arange(st.capacity, dtype=torch.int32).flip(0)
    with torch.no_grad():
        return [conv(st, {})[0].features, merge_take_rows(st.features, idx)]


# each switch, one value the JAX package reads as another path, one other
# spelling it reads as the default's path, and the port's entry points
# that read it
SWITCHES = [('MSMD_GMA_NN', 'exact', 'approx2', gma_forward),
            ('MSMD_GMA_DUMMY', 'random:0', 'learnt', gma_forward),
            ('MSMD_FUSE_BN', '0', 'true', blocks_forward),
            ('MSMD_SPARSE_BACKEND', 'xla', 'pallas', backend_forward)]


@pytest.mark.parametrize('name,value,same,forward', SWITCHES,
                         ids=[s[0] for s in SWITCHES])
@pytest.mark.parametrize('at_default', [False, True, 'equivalent'],
                         ids=['other', 'default', 'equivalent'])
def test_unported_switch_raises_or_runs_as_unset(name, value, same, forward,
                                                 at_default, monkeypatch):
    monkeypatch.delenv(name, raising=False)
    if at_default:
        unset = forward()
        monkeypatch.setenv(name, UNPORTED[name][0] if at_default is True
                           else same)
        for got, want in zip(forward(), unset):
            assert torch.equal(got, want)
        assert any(bool(w.abs().sum() > 0) for w in unset)
    else:
        monkeypatch.setenv(name, value)
        with pytest.raises(ValueError, match=name):
            forward()
