"""Model builder (reference mmdet3d/models/builder.py).

``build_detector(cfg.model)`` instantiates the registered detector on the
card (``device='cuda'``, the default) or, when asked, on the CPU, in eval
mode. A seed re-draws every weight and batch-norm statistic from an
explicit ``torch.Generator`` (``init_random_weights``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
from torch import nn

from ..registry import DETECTORS


def _plain(cfg):
    """ConfigDict trees -> plain dict/list."""
    if isinstance(cfg, dict):
        return {k: _plain(v) for k, v in cfg.items()}
    if isinstance(cfg, (list, tuple)):
        return type(cfg)(_plain(v) for v in cfg)
    return cfg


@torch.no_grad()
def init_random_weights(model: nn.Module, generator: torch.Generator,
                        bn_spread: float = 0.1) -> nn.Module:
    """Draw every parameter and batch-norm statistic from ``generator``.

    Conv and linear weights: zero-mean normal with std sqrt(2 / fan_in),
    fan_in = all but the output axis (spconv weights are [O, ..., I]; a
    transposed conv's is [I, O, kh, kw]). Biases: normal, std 0.01. Batch
    norms: weight and running var in 1 +- ``bn_spread``, bias and running
    mean normal with std ``bn_spread`` / 10, so every folded epilogue is a
    real affine. GMA dummy embeddings: uniform in [0, 1). Draws run on the
    CPU, so one seed gives the same weights on every device.
    """
    def normal(shape, std):
        return torch.randn(shape, generator=generator) * std

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=generator) * (hi - lo) + lo

    for module in model.modules():
        if isinstance(module, nn.modules.batchnorm._BatchNorm):
            c = module.num_features
            module.weight.copy_(uniform(c, 1 - bn_spread, 1 + bn_spread))
            module.bias.copy_(normal(c, bn_spread / 10))
            module.running_mean.copy_(normal(c, bn_spread / 10))
            module.running_var.copy_(uniform(c, 1 - bn_spread,
                                             1 + bn_spread))
            continue
        for name, p in module.named_parameters(recurse=False):
            if p.dim() == 1:
                if name.startswith('dummy_embedding'):
                    p.copy_(uniform(p.shape, 0.0, 1.0))   # as the JAX init
                elif name == 'bias' and isinstance(module, nn.LayerNorm):
                    p.zero_()
                elif isinstance(module, nn.LayerNorm):
                    p.fill_(1.0)
                else:
                    p.copy_(normal(p.shape, 0.01))
                continue
            if isinstance(module, nn.ConvTranspose2d):
                fan_in = p.shape[0]
            else:
                fan_in = p[0].numel()
            p.copy_(normal(p.shape, math.sqrt(2.0 / fan_in)))
    return model


def build_detector(cfg: Dict[str, Any], device='cuda',
                   seed: Optional[int] = None) -> nn.Module:
    """The detector of ``cfg`` (a config's ``model`` dict) on ``device``,
    in eval mode; ``seed`` draws random weights (``init_random_weights``).
    ``device='cuda'`` with no card raises: there is no silent fallback to
    the CPU."""
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            f'device {device!r} requested but torch.cuda.is_available() is '
            'False; pass device="cpu" to run on the CPU')
    model = DETECTORS.build(_plain(dict(cfg)))
    if seed is not None:
        init_random_weights(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
