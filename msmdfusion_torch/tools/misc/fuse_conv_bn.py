"""Fold frozen batch-norm statistics into the preceding convs.

Counterpart of the JAX package's ``tools/misc/fuse_conv_bn.py``
(reference tools/misc/fuse_conv_bn.py) on the port's checkpoint files
(``utils/checkpoint.py``): the config's detector is built, the checkpoint
loaded, each pair folded, and ``{state_dict, step, meta}`` written to OUT
(``meta['fused_conv_bn']``: the pairs folded), which loads into the same
model: every batch norm stays, neutralised (weight 1, bias ``beta -
mean x factor``, running mean 0, running var ``1 - eps``), so that it adds
its bias and nothing else.

    python -m msmdfusion_torch.tools.misc.fuse_conv_bn CONFIG CHECKPOINT \\
        OUT [--cfg-options key=value ...] [--device cuda]

**Which pairs.** The JAX tool folds, in each flax scope that holds both, a
``Conv_0``/``SubMConv3d_0``/``SparseConv3d_0``/``ConvTranspose_0``/
``Dense_0`` with the ``MaskedBatchNorm_0``. ``fold_pairs`` finds the same
pairs by walking the port's modules: a conv followed by its batch norm in
an ``nn.Sequential`` (SECOND's layers, the sparse conv blocks, the
detector's compressions and SPP branches, the position embeddings'
heads), a ``ConvModule``'s ``conv`` and ``bn`` (the heatmap heads), a
``SparseBasicBlock``'s ``conv1`` and ``bn1`` (its flax scope holds both
pairs, and the JAX tool takes the first), and ``SECONDFPN``'s first
non-transposed conv with the first deblock's norm (one flax scope for
all deblocks). ResNet's norms (``bn1``, ``downsample_bn``) and the
prediction heads' (``{head}_{i}_bn``) carry other flax names, which the
JAX tool does not match, so neither is folded here.

**How.** ``factor = gamma / sqrt(var + eps)`` scales the conv's output
channels. Two departures from the JAX tool, which folds every pair with
``eps=1e-3`` (``fuse_conv_bn.py:27``) and leaves a conv's own bias
unscaled (``:44-47``): each pair is folded with its norm's own ``eps``
(``ConvModule``'s is 1e-5: the TransFusion head's ``heatmap_conv1``),
and a conv bias is scaled by ``factor`` (``heatmap_conv1`` and the
position embeddings' first convs have one), as mmcv's ``fuse_conv_bn``
does. The fused model then computes what the unfused one does; on those
pairs the JAX tool's output does not.
"""
from __future__ import annotations

import argparse
from typing import Dict, Iterator, List, Optional, Tuple

import torch
from torch import nn

BatchNorm = nn.modules.batchnorm._BatchNorm


def _conv_types():
    from ...models.sparse_blocks import SparseConv3d, SubMConv3d
    return (nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d, nn.Linear,
            SubMConv3d, SparseConv3d)


def _sequential_pairs(seq, prefix) -> Iterator[Tuple[str, nn.Module,
                                                     str, nn.Module]]:
    names = list(seq._modules)
    for a, b in zip(names, names[1:]):
        conv, bn = seq._modules[a], seq._modules[b]
        if isinstance(conv, _conv_types()) and isinstance(bn, BatchNorm):
            yield f'{prefix}{a}', conv, f'{prefix}{b}', bn


def _neck_pair(neck, prefix):
    """SECONDFPN's flax scope: ``Conv_0`` (its first non-transposed conv)
    with ``MaskedBatchNorm_0`` (its first deblock's norm)."""
    plain = [i for i, d in enumerate(neck.deblocks)
             if not isinstance(d[0], nn.ConvTranspose2d)]
    if not plain:
        return
    if plain[0] != 0:
        raise ValueError(f'{prefix}deblocks: the JAX tool would fold deblock '
                         f'{plain[0]}\'s conv with deblock 0\'s norm')
    yield (f'{prefix}deblocks.0.0', neck.deblocks[0][0],
           f'{prefix}deblocks.0.1', neck.deblocks[0][1])


def fold_pairs(model: nn.Module, prefix: str = ''
               ) -> List[Tuple[str, nn.Module, str, nn.Module]]:
    """[(conv name, conv, norm name, norm)]: the pairs the JAX tool folds
    in the same model (see the module docstring), in module order."""
    from ...models.backbones.resnet import ResNet
    from ...models.heads.transfusion_head import FFN
    from ...models.layers import ConvModule
    from ...models.necks.second_fpn import SECONDFPN
    from ...models.sparse_blocks import SparseBasicBlock
    if isinstance(model, (ResNet, FFN)):
        return []
    if isinstance(model, SparseBasicBlock):
        return [(f'{prefix}conv1', model.conv1, f'{prefix}bn1', model.bn1)]
    if isinstance(model, SECONDFPN):
        return list(_neck_pair(model, prefix))
    pairs = []
    if isinstance(model, ConvModule) and model.bn is not None:
        pairs.append((f'{prefix}conv', model.conv, f'{prefix}bn', model.bn))
    elif isinstance(model, nn.Sequential):
        pairs += _sequential_pairs(model, prefix)
    for name, child in model.named_children():
        pairs += fold_pairs(child, f'{prefix}{name}.')
    return pairs


@torch.no_grad()
def fuse_pair(conv: nn.Module, bn: BatchNorm) -> None:
    """Fold ``bn``'s statistics into ``conv`` in place (see the module
    docstring); the output channels are the weight's axis 1 for a
    transposed conv, axis 0 otherwise."""
    factor = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    axis = 1 if isinstance(conv, nn.ConvTranspose2d) else 0
    shape = [1] * conv.weight.dim()
    shape[axis] = -1
    conv.weight.mul_(factor.reshape(shape).to(conv.weight.dtype))
    if conv.bias is not None:
        conv.bias.mul_(factor.to(conv.bias.dtype))
    bn.bias.copy_(bn.bias - bn.running_mean * factor)
    bn.weight.fill_(1.0)
    bn.running_mean.zero_()
    bn.running_var.fill_(1.0 - bn.eps)


def fuse_conv_bn(model: nn.Module) -> int:
    """Fold every pair of ``fold_pairs(model)``; returns their number."""
    pairs = fold_pairs(model)
    for _, conv, _, bn in pairs:
        fuse_pair(conv, bn)
    return len(pairs)


def parse_args(argv: Optional[List[str]] = None):
    from .. import add_device
    p = argparse.ArgumentParser(description='fold batch norms into convs')
    p.add_argument('config')
    p.add_argument('checkpoint')
    p.add_argument('out')
    p.add_argument('--cfg-options', nargs='+', default=[])
    add_device(p, 'the model')
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict:
    """Run the tool; returns dict(model: the fused model, fused: the pairs
    folded, out)."""
    from ...config import load_config, parse_cli_overrides
    from ...models.builder import build_detector
    from ...utils.checkpoint import load_checkpoint
    from .. import device_of
    import msmdfusion_torch.models  # noqa: F401  (registers the modules)
    args = parse_args(argv)
    device = device_of(args)
    cfg = load_config(args.config, parse_cli_overrides(args.cfg_options))
    model = build_detector(cfg.model, device=device)
    state = load_checkpoint(args.checkpoint, model)
    n = fuse_conv_bn(model)
    print(f'fused {n} conv+bn pairs')
    torch.save({'state_dict': {k: v.detach().cpu()
                               for k, v in model.state_dict().items()},
                'step': int(state.get('step', 0)),
                'meta': dict(state.get('meta', {}), fused_conv_bn=n)},
               args.out)
    return dict(model=model, fused=n, out=args.out)


if __name__ == '__main__':
    main()
