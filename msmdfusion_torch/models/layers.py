"""Shared building blocks: masked batch norm over sparse rows, ConvModule,
and the dense layers under flax's dtype rule.

Counterpart of the JAX package's ``models/layers.py``. Batch norms follow
the module's mode: running statistics in eval mode, the batch's moments
(and a running-statistics update) in training mode; folding a norm into a
conv epilogue is eval-only. Parameter and buffer names are the
reference mmdet3d/mmcv ones (``weight``, ``bias``, ``running_mean``,
``running_var``; ConvModule's ``conv``/``bn``), so a reference checkpoint
and the JAX package's converter both read a port ``state_dict()`` as is.

Dtypes follow flax's layers with ``dtype=None``, as the JAX package's
``compute_dtype='bfloat16'`` runs them: a conv, linear or layer norm
computes in the common type of its input and its parameters (bf16 only
where both are bf16; fp32 parameters on a bf16 input compute and return
fp32), and a batch norm computes in fp32 and returns its input's dtype
(``MaskedBatchNorm``, JAX ``layers.py:60-92``). PyTorch does not promote
(a conv on mixed dtypes raises), so ``Conv1d``, ``Conv2d``,
``ConvTranspose2d``, ``Linear``, ``LayerNorm``, ``BatchNorm1d`` and
``BatchNorm2d`` below cast explicitly and, below fp32, add a bias after
the product as flax does, each rounded; on fp32 inputs and parameters the
casts are no-ops. ``cast_params`` casts a model's parameters as the JAX
bench casts its params tree (``bench.py:128-133``): parameters only, the
norms' running statistics stay fp32.

Inside a process group (``parallel.distributed``) a batch norm in training
mode takes its moments over every rank's rows (``global_moments``: the
JAX package's two passes, ``layers.py:69-84``, each sum over the group),
as the JAX package's are over a batch-sharded mesh; the running statistics
then come out the same on every rank. Outside one they are this process's.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.distributed import all_sum, grouped


def get_activation(name: Optional[str]) -> Optional[Callable]:
    if name is None:
        return None
    return {
        'relu': F.relu,
        'gelu': F.gelu,
        'silu': F.silu,
        'sigmoid': torch.sigmoid,
    }[name.lower()]


@contextlib.contextmanager
def cudnn_enabled(enabled: bool):
    """Run the convolutions of the scope on cuDNN or, with ``enabled``
    False, on PyTorch's own kernels (im2col + cuBLAS, or its dilated conv).
    The flag is global; it is restored on exit.

    The layers whose fp32 cuDNN engine (TF32 off) measured slower on an
    H100 than PyTorch's own path run with it off: SECOND (its first conv,
    256 -> 128 3x3 at 180 x 180, two orders of magnitude slower on cuDNN),
    ResNet-50 on six 448 x 800 images (1.2x), SPP's two dilated 3x3
    convs at 180 x 180 (1.5-1.7x) and the TransFusion-LC head's
    ``shared_conv_img`` (256 -> 128 3x3 over six 112 x 200 maps: cuDNN
    picked an FFT engine with a complex GEMM, ~430 ms). In bf16 (parameters cast, the JAX
    package's ``MSMD_BF16``) ResNet-50 runs on cuDNN: 8.4-8.8 ms there
    against 14.1 off it (the only dense layers that compute in bf16 are
    the image branch's). ``chip_smoke.py``'s dense-engine lines time these
    and the other new dense shapes both ways on every run."""
    was = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = enabled
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = was


def common_dtype(x, *params) -> torch.dtype:
    """The type flax computes a ``dtype=None`` layer in: the promotion of
    the input's and the parameters' types."""
    dt = x.dtype
    for p in params:
        if p is not None:
            dt = torch.promote_types(dt, p.dtype)
    return dt


def promoted(x, *params):
    """``x`` and ``params`` (None kept) cast to their ``common_dtype``."""
    dt = common_dtype(x, *params)
    return (x.to(dt),) + tuple(None if p is None else p.to(dt)
                               for p in params)


def _then_bias(out, b, dims: int):
    """``out + b`` over ``dims`` trailing spatial axes: flax adds a bias
    after the product, so below fp32 the two round apart."""
    return out + b.reshape(-1, *([1] * dims))


class _FlaxConv:
    def forward(self, x):
        x, w, b = promoted(x, self.weight, self.bias)
        if b is None or x.dtype == torch.float32:
            return self._conv_forward(x, w, b)
        return _then_bias(self._conv_forward(x, w, None), b, w.dim() - 2)


class Conv1d(_FlaxConv, nn.Conv1d):
    pass


class Conv2d(_FlaxConv, nn.Conv2d):
    pass


class ConvTranspose2d(nn.ConvTranspose2d):
    def forward(self, x):
        x, w, b = promoted(x, self.weight, self.bias)
        fp32 = x.dtype == torch.float32
        out = F.conv_transpose2d(x, w, b if fp32 else None, self.stride,
                                 self.padding, self.output_padding,
                                 self.groups, self.dilation)
        return out if fp32 or b is None else _then_bias(out, b, 2)


class Linear(nn.Linear):
    def forward(self, x):
        x, w, b = promoted(x, self.weight, self.bias)
        if b is None or x.dtype == torch.float32:
            return F.linear(x, w, b)
        return F.linear(x, w) + b


class LayerNorm(nn.LayerNorm):
    def forward(self, x):
        x, w, b = promoted(x, self.weight, self.bias)
        return F.layer_norm(x, self.normalized_shape, w, b, self.eps)


def global_moments(xf, dims, weight=None):
    """(mean, biased variance, count) of fp32 ``xf`` over ``dims`` (mean
    and variance keep those dims, of size 1), rows weighted by ``weight``
    (0 or 1, broadcast against ``xf``; all rows where None), over every
    rank of the process group: the count and the sum summed over the ranks
    (one reduction), then the squared deviations from the global mean (a
    second); the count clamped to at least 1 after the sum, so a rank may
    hold no valid row. Without a group, this process's moments in the same
    arithmetic."""
    if weight is None:
        s = xf.sum(dims, keepdim=True)
        count = xf.new_full((), xf.numel() / s.numel())  # a fill: no copy
    else:
        s = (xf * weight).sum(dims, keepdim=True)
        count = weight.sum().to(xf.dtype)
    packed = all_sum(torch.cat([s.reshape(-1), count.reshape(1)]))
    count = torch.clamp(packed[-1], min=1.0)
    mean = (packed[:-1] / count).reshape(s.shape)
    dev = (xf - mean) ** 2
    if weight is not None:
        dev = dev * weight
    return mean, all_sum(dev.sum(dims, keepdim=True)) / count, count


@torch.no_grad()
def update_running(bn, mean, var, count, unbiased: bool = True):
    """The running statistics' update with torch's momentum convention
    (new = (1 - m) old + m batch): the unbiased variance, or with
    ``unbiased=False`` the biased one ``var`` itself (flax's
    ``BatchNorm``, whose ``momentum`` is 1 - m)."""
    m = bn.momentum
    var = var.reshape(-1)
    if unbiased:
        var = var * count / torch.clamp(count - 1.0, min=1.0)
    bn.running_mean.mul_(1 - m).add_(m * mean.reshape(-1))
    bn.running_var.mul_(1 - m).add_(m * var)
    bn.num_batches_tracked.add_(1)


class _Fp32Norm:
    """A torch batch norm on any input and parameter dtype: computed in
    fp32, returned in the input's dtype (as the module itself on fp32).
    In training mode the moments are those of the widened input and the
    running statistics (fp32) update as the module's own do (JAX
    ``MaskedBatchNorm``, ``layers.py:69-92``); inside a process group they
    are the global moments (``global_moments``)."""

    def forward(self, x):
        if self.training and grouped():
            xf = x.float()
            mean, var, count = global_moments(xf, (0, *range(2, x.dim())))
            update_running(self, mean, var, count)
            shape = (1, -1) + (1,) * (x.dim() - 2)
            y = (xf - mean) * torch.rsqrt(var + self.eps) \
                * self.weight.float().reshape(shape) \
                + self.bias.float().reshape(shape)
            return y.to(x.dtype)
        if x.dtype == torch.float32 and self.weight.dtype == torch.float32:
            return super().forward(x)
        if self.training:
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x.float(), self.running_mean, self.running_var,
                            self.weight.float(), self.bias.float(),
                            self.training, self.momentum if self.training
                            else 0.0, self.eps).to(x.dtype)


class BatchNorm1d(_Fp32Norm, nn.BatchNorm1d):
    pass


class BatchNorm2d(_Fp32Norm, nn.BatchNorm2d):
    pass


class BatchNorm3d(_Fp32Norm, nn.BatchNorm3d):
    pass


def cast_params(model: nn.Module, dtype=torch.bfloat16) -> nn.Module:
    """Cast every fp32 parameter of ``model`` to ``dtype`` in place (the
    JAX bench's ``MSMD_BF16`` cast of its params tree): buffers, the
    norms' running statistics among them, stay as they are."""
    for p in model.parameters():
        if p.dtype == torch.float32:
            p.data = p.data.to(dtype)
    return model


def batch_norm_last(bn: nn.modules.batchnorm._BatchNorm, x):
    """Batch norm over the last axis of ``x`` (any rank), as a call of the
    module on [rows, C] (so its hooks run): in training mode the moments
    are over all leading axes, as the JAX package's unmasked
    ``MaskedBatchNorm``."""
    c = x.shape[-1]
    return bn(x.reshape(-1, c)).reshape(x.shape)


class MaskedBatchNorm(nn.BatchNorm1d):
    """Batch norm over channels-last rows [K, C] with an optional validity
    mask: ``y = (x - mean) * rsqrt(var + eps) * weight + bias``, rows
    outside ``mask`` zeroed, computed in fp32 and returned in ``x``'s
    dtype.

    Eval mode uses the running statistics. Training mode uses the moments
    of the valid rows only (``nn.BatchNorm1d``'s own would count the
    padding rows): the biased variance normalises, and the running mean
    and the unbiased variance update with torch's momentum convention
    (new = (1 - m) * old + m * batch); inside a process group the moments
    and the count are every rank's (``global_moments``). ``fold()`` (eval
    only) returns the affine as ``(scale, shift)`` for fusion into a conv
    kernel's epilogue. A subclass with ``unbiased_running = False`` keeps
    the biased variance instead, as flax's ``BatchNorm`` does.
    """
    unbiased_running = True

    def forward(self, x, mask=None):
        xf = x.float()
        if not self.training:
            y = F.batch_norm(xf, self.running_mean, self.running_var,
                             self.weight.float(), self.bias.float(), False,
                             0.0, self.eps)
        else:
            w = (torch.ones_like(xf[:, :1]) if mask is None
                 else mask.to(xf.dtype)[:, None])
            mean, var, count = global_moments(xf, (0,), w)
            update_running(self, mean, var, count, self.unbiased_running)
            y = (xf - mean) * torch.rsqrt(var + self.eps) * self.weight \
                + self.bias
        if mask is not None:
            y = torch.where(mask[:, None], y, 0.0)
        return y.to(x.dtype)

    def fold(self):
        """(scale, shift) with ``bn(x) == x * scale + shift``."""
        if self.training:
            raise ValueError('fold() is an eval-mode transformation')
        s = self.weight * torch.rsqrt(self.running_var + self.eps)
        return s, self.bias - self.running_mean * s


class ConvModule(nn.Module):
    """conv (1-D or 2-D, channels-first) + batch norm + activation.

    mmcv ConvModule naming (``conv``, ``bn``); reference semantics
    mmcv/cnn/bricks/conv_module.py, JAX counterpart ``layers.ConvModule``.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 1, stride: int = 1, padding: int = 0,
                 bias: bool = False, conv_dim: int = 2, norm: bool = True,
                 norm_eps: float = 1e-5, norm_momentum: float = 0.1,
                 act: Optional[str] = 'relu'):
        super().__init__()
        conv = Conv2d if conv_dim == 2 else Conv1d
        bn = BatchNorm2d if conv_dim == 2 else BatchNorm1d
        self.conv = conv(in_channels, out_channels, kernel_size,
                         stride=stride, padding=padding, bias=bias)
        self.bn = (bn(out_channels, eps=norm_eps, momentum=norm_momentum)
                   if norm else None)
        self.act = get_activation(act)

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        if self.act is not None:
            x = self.act(x)
        return x


def pointwise(conv: nn.Module, x):
    """A kernel-1 Conv1d applied to channels-last ``x`` [..., Cin]."""
    w = conv.weight
    return F.linear(*promoted(x, w.reshape(w.shape[0], w.shape[1]),
                              conv.bias))


class MLP(nn.Sequential):
    """Linear layers with a ReLU between them and, with ``final_act``,
    after the last (JAX counterpart ``layers.MLP``). A one-layer MLP's
    Linear is module ``0``, the reference's ``score_net.0`` and
    ``gate_control.{i}.0``."""

    def __init__(self, in_channels: int, features, final_act: bool = False,
                 bias: bool = True):
        layers = []
        c = in_channels
        for i, f in enumerate(features):
            layers.append(Linear(c, f, bias=bias))
            if i < len(features) - 1 or final_act:
                layers.append(nn.ReLU())
            c = f
        super().__init__(*layers)
