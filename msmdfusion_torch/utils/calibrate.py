"""Batch-norm statistics calibrated on given inputs.

With random weights and made-up running statistics, activations grow
layer by layer (the MSMDFusion flagship's GMA features reach ~1e8, since
its gates multiply features), and a comparison scaled by the largest
value then says little about the small ones. A trained checkpoint's
running statistics are close to the statistics of its inputs on real
data. ``calibrate_norms`` runs one forward in which every batch norm's
running mean and variance are set, just before the norm is applied, to
the per-channel mean and (biased) variance of its input on the given
inputs. Norms run in forward order, so each one sees inputs that are
already calibrated upstream; the weights and the norms' affine stay as
they were.

- Norms called as modules on channels-first inputs (dense convs,
  ``layers.batch_norm_last``): a forward pre-hook sets the statistics
  from the input's rows.
- Norms folded into a sparse conv's epilogue (``SparseConvBlock``,
  ``SparseBasicBlock``): a hook on the conv reruns it without the
  epilogue, sets the norm from the valid output rows, and reruns it with
  the new fold.
"""
from __future__ import annotations

import functools

import torch
from torch import nn

from ..models.sparse_blocks import SparseBasicBlock, SparseConvBlock


def _set_stats(bn: nn.modules.batchnorm._BatchNorm, rows) -> None:
    """Running mean and biased variance of ``rows`` [R, C] (kept when R
    is 0)."""
    if rows.shape[0] == 0:
        return
    bn.running_mean.copy_(rows.mean(0))
    bn.running_var.copy_(rows.var(0, unbiased=False))


def _from_input(bn, args):
    x = args[0]                                 # channels on axis 1
    _set_stats(bn, x.movedim(1, -1).reshape(-1, x.shape[1]))


def _refold(bn, conv, args, kwargs, output):
    del output
    st, cache = args[:2]
    raw, _ = conv.forward(st, cache)            # forward(): no hooks
    _set_stats(bn, raw.features[raw.valid])
    scale, shift = bn.fold()
    return conv.forward(st, cache, scale=scale, shift=shift,
                        relu=kwargs.get('relu', False))


def _folded_pairs(model: nn.Module):
    """(sparse conv, the norm folded into its epilogue) of every block."""
    for m in model.modules():
        if isinstance(m, SparseConvBlock):
            yield m[0], m[1]
        elif isinstance(m, SparseBasicBlock):
            yield m.conv1, m.bn1
            yield m.conv2, m.bn2


@torch.no_grad()
def calibrate_norms(model: nn.Module, *inputs, **kwargs):
    """Set every batch norm of ``model`` from its inputs in one forward
    ``model(*inputs, **kwargs)``; returns that forward's output."""
    handles, folded = [], set()
    for conv, bn in _folded_pairs(model):
        folded.add(bn)
        handles.append(conv.register_forward_hook(
            functools.partial(_refold, bn), with_kwargs=True))
    for m in model.modules():
        if isinstance(m, nn.modules.batchnorm._BatchNorm) and m not in folded:
            handles.append(m.register_forward_pre_hook(_from_input))
    try:
        return model(*inputs, **kwargs)
    finally:
        for h in handles:
            h.remove()
