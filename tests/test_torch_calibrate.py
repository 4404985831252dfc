"""Port ``calibrate_norms`` on the tiny flagship, on the CPU.

After one calibrating forward, every batch norm's running mean and
variance are the statistics of its own input in a second, plain forward
(dense norms: all rows of their input; norms folded into a sparse conv:
the valid rows of the conv's output before the epilogue), the hooks are
gone, and the calibrating forward's output is that plain forward's.
"""
import numpy as np
import pytest
import torch
from torch import nn

from msmdfusion_torch.models.builder import build_detector
from msmdfusion_torch.utils.calibrate import _folded_pairs, calibrate_norms
from tests.test_torch_msmdfusion import make_batch, port_inputs, tiny_config


@pytest.fixture(scope='module')
def calibrated():
    model = build_detector(tiny_config(), device='cpu', seed=0)
    inputs = port_inputs(make_batch(np.random.RandomState(0)))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    preds = calibrate_norms(model, *inputs)
    return model, inputs, before, preds


def _plain_forward_inputs(model, inputs):
    """One forward; {norm: rows it normalises} and the predictions."""
    seen, handles = {}, []
    folded = dict((bn, conv) for conv, bn in _folded_pairs(model))

    def dense(bn, args):
        x = args[0]
        seen[bn] = x.movedim(1, -1).reshape(-1, x.shape[1])

    def sparse(bn, conv, args, kwargs, output):
        raw, _ = conv.forward(*args[:2])
        seen[bn] = raw.features[raw.valid]

    for bn, conv in folded.items():
        handles.append(conv.register_forward_hook(
            lambda c, a, k, o, bn=bn: sparse(bn, c, a, k, o),
            with_kwargs=True))
    for m in model.modules():
        if isinstance(m, nn.modules.batchnorm._BatchNorm) and m not in folded:
            handles.append(m.register_forward_pre_hook(dense))
    try:
        with torch.no_grad():
            preds = model(*inputs)
    finally:
        for h in handles:
            h.remove()
    return seen, preds


def test_norm_statistics_are_those_of_their_inputs(calibrated):
    model, inputs, before, _ = calibrated
    seen, _ = _plain_forward_inputs(model, inputs)
    norms = [m for m in model.modules()
             if isinstance(m, nn.modules.batchnorm._BatchNorm)]
    assert len(norms) > 50 and set(norms) == set(seen)
    for bn in norms:
        rows = seen[bn]
        assert rows.shape[0] > 0
        scale = float(rows.abs().max()) + 1e-6
        np.testing.assert_allclose(bn.running_mean.numpy(),
                                   rows.mean(0).numpy(), rtol=1e-4,
                                   atol=1e-5 * scale)
        np.testing.assert_allclose(bn.running_var.numpy(),
                                   rows.var(0, unbiased=False).numpy(),
                                   rtol=1e-4, atol=1e-5 * scale ** 2)
    after = model.state_dict()
    for key, value in before.items():
        if key.endswith(('running_mean', 'running_var')):
            continue
        assert torch.equal(after[key], value), key


def test_calibrating_forward_is_the_plain_forward(calibrated):
    model, inputs, _, preds = calibrated
    assert not any(m._forward_hooks or m._forward_pre_hooks
                   for m in model.modules())
    with torch.no_grad():
        again = model(*inputs)
    for key in ('dense_heatmap', 'heatmap', 'center', 'dim'):
        np.testing.assert_allclose(preds[key].numpy(), again[key].numpy(),
                                   rtol=1e-5, atol=1e-5)
    hm = preds['dense_heatmap']
    assert bool(torch.isfinite(hm).all()) and float(hm.abs().max()) < 1e3
