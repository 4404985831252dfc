"""Masked nearest-neighbour argmin (the [Na, Nb] distances are never stored).

Counterpart of the JAX package's ``ops/nn_argmin.py`` (``masked_nn``), the
search behind the GMA orphan gating (``gma_encoder.approx_nn_3d``). The
hand-written CUDA kernel ``csrc/masked_nn.cu`` replaces ``_nn_kernel``; the
wrapper launches it for CUDA tensors (raising if the build or the launch
fails) and runs the plain PyTorch version for CPU tensors or inside
``kernels.plain_kernels()``.

Contract: for each row i of ``a``, the least j minimising
``max(|a_i|^2 + |b_j|^2 - 2 a_i.b_j, 0)`` over the rows of ``b`` that are
valid and share ``a``'s batch id; (-1, +inf) when there is none. All
arithmetic is fp32 in one fixed order (no TF32, no fused multiply-add),
so the kernel and the plain version agree bit for bit.
"""
from __future__ import annotations

import torch

from .. import kernels
from ..kernels import check_tensor

# rows of A per chunk of the plain version: bounds its [chunk, Nb] temporaries
_PLAIN_ELEMS = 1 << 24


def _sq_norm(x):
    return x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1] + x[:, 2] * x[:, 2]


def masked_nn_plain(a, ab, b, bb, b_valid):
    """Plain version of ``masked_nn``: dense distances over chunks of A's
    rows (the JAX package's non-TPU path, ``nn_argmin.py:74-82``)."""
    na = a.shape[0]
    idx = torch.full((na,), -1, dtype=torch.int32, device=a.device)
    d2 = torch.full((na,), float('inf'), dtype=torch.float32, device=a.device)
    if na == 0 or b.shape[0] == 0:
        return idx, d2
    b2 = _sq_norm(b)
    step = max(1, _PLAIN_ELEMS // b.shape[0])
    for s in range(0, na, step):
        x = a[s:s + step]
        prod = (x[:, 0:1] * b[:, 0] + x[:, 1:2] * b[:, 1]) + \
            x[:, 2:3] * b[:, 2]
        d = (_sq_norm(x)[:, None] + b2[None, :]) - 2.0 * prod
        ok = (ab[s:s + step, None] == bb[None, :]) & b_valid[None, :]
        d = torch.where(ok, torch.clamp(d, min=0.0), float('inf'))
        dmin, imin = torch.min(d, dim=1)     # first index of the minimum
        found = torch.isfinite(dmin)
        idx[s:s + step] = torch.where(found, imin, -1).to(torch.int32)
        d2[s:s + step] = dmin
    return idx, d2


def masked_nn(a, ab, b, bb, b_valid):
    """Nearest valid same-batch row of ``b`` for every row of ``a``.

    a [Na, 3] f32, ab [Na] int32 batch ids; b [Nb, 3] f32, bb [Nb] int32,
    b_valid [Nb] bool -> (idx [Na] int32, -1 = none; d2 [Na] f32).
    """
    dev = a.device
    check_tensor('a', a, torch.float32, 2, dev)
    check_tensor('ab', ab, torch.int32, 1, dev)
    check_tensor('b', b, torch.float32, 2, dev)
    check_tensor('bb', bb, torch.int32, 1, dev)
    check_tensor('b_valid', b_valid, torch.bool, 1, dev)
    na, nb = a.shape[0], b.shape[0]
    if a.shape[1] != 3 or b.shape[1] != 3 or ab.shape[0] != na or \
            bb.shape[0] != nb or b_valid.shape[0] != nb:
        raise ValueError(f'shape mismatch: a {tuple(a.shape)}, ab '
                         f'{tuple(ab.shape)}, b {tuple(b.shape)}, bb '
                         f'{tuple(bb.shape)}, b_valid {tuple(b_valid.shape)}')
    if not kernels.use_kernel(a):
        return masked_nn_plain(a, ab, b, bb, b_valid)
    fn = kernels.entry_point('masked_nn')
    scratch = torch.empty((na,), dtype=torch.int64, device=dev)
    idx = torch.empty((na,), dtype=torch.int32, device=dev)
    d2 = torch.empty((na,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        kernels.check('masked_nn', fn(
            a.data_ptr(), ab.data_ptr(), na, b.data_ptr(), bb.data_ptr(),
            b_valid.data_ptr(), nb, scratch.data_ptr(), idx.data_ptr(),
            d2.data_ptr(), stream))
    kernels.launches['masked_nn'] += 1
    return idx, d2
