"""Port MSMDFusion on the trained golden fixture vs the JAX package's boxes.

``tests/data/golden_flagship.npz`` holds a 40-step-trained tiny flagship
(ResNet-18, 128 x 128 grid; the frozen image branch is regenerated from
its seeded init) and the boxes the JAX package decoded from it on a
held-out realistic scene. The same variables go into the port through
``from_jax_variables``; its boxes must meet the tolerances the JAX
package's own golden test holds itself to (``tests/test_golden_box.py``):
labels and validity equal, scores to 1e-5, boxes to 1e-4. Trained
weights, unlike random ones, keep the features at their real scale.
"""
import os
import sys

import numpy as np
import jax
import torch

import msmdfusion_torch.models  # noqa: F401
from msmdfusion_torch.models.builder import build_detector
from msmdfusion_torch.utils import overflow
from msmdfusion_torch.utils.convert import (from_jax_variables,
                                            msmdfusion_rules)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import golden_flagship as gf  # noqa: E402


def test_port_decodes_the_golden_boxes():
    data = dict(np.load(gf.FIXTURE, allow_pickle=False))
    want = {k.split('|', 1)[1]: v for k, v in data.items()
            if k.startswith('golden|')}
    jmodel = gf.build_model()
    batch = gf.eval_batch()
    variables = jax.tree_util.tree_map(np.asarray,
                                       gf.load_variables(jmodel, batch))
    port = build_detector(gf.golden_config(), device='cpu')
    port.load_state_dict(from_jax_variables(
        variables, msmdfusion_rules(depth=18, layer_nums=(2, 2))))

    def t(x):
        return torch.from_numpy(np.asarray(x))
    with torch.no_grad(), overflow.capture():
        preds = port(t(batch['points']), t(batch['points_mask']),
                     t(batch['img']), {k: t(v) for k, v in batch['fg'].items()})
        got = {k: v.numpy() for k, v in port.get_bboxes(preds).items()}
    assert set(got) == set(want)
    np.testing.assert_array_equal(got['labels'], want['labels'])
    np.testing.assert_array_equal(got['valid'], want['valid'])
    np.testing.assert_allclose(got['scores'], want['scores'], atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(got['bboxes'], want['bboxes'], atol=1e-4,
                               rtol=1e-4)
    assert got['valid'].sum() > 16 and np.abs(got['bboxes']).max() > 1.0
