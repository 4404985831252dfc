"""Row gather with an optional duplicate-row add (the ``sparse_add`` rows).

Counterpart of the JAX package's ``ops/sparse/merge_take.py``
(``merge_take_rows``):

    out[r] = table[idx[r]] + (dup[r] ? table[idx2[r]] : 0)

with an index outside ``[0, len(table))`` (INT_MAX on the callers' inactive
rows) contributing zero. The hand-written CUDA kernel
``csrc/merge_take.cu`` replaces ``_kernel``; the wrapper launches it for
CUDA tensors (raising if the build or the launch fails), by float4 slices
of rows or, at a width that is not a multiple of 4 or on unaligned
tensors, by elements (``take_vec4``), and runs the plain PyTorch version
for CPU tensors, inside ``kernels.plain_kernels()`` or under
``MSMD_SPARSE_BACKEND=xla`` (``kernels.sparse_backend``).

The TPU kernel's sliding windows and bf16 hi/lo split have no counterpart:
the gather is exact fp32 and never drops a row, so ``merge_take.win[site]``
is recorded as 0 to keep the overflow sites' names.

The gather is differentiable in ``table``: its backward is the
scatter-add of the JAX package's custom VJP (``_vjp_bwd``, plain XLA
there, ``index_add_`` here), and rows read through an out-of-range index
receive nothing.
"""
from __future__ import annotations

from typing import Optional

import torch

from ... import kernels
from ...utils import overflow
from ...kernels import check_tensor


def merge_take_rows_plain(table, idx, idx2=None, dup=None):
    """Plain version of ``merge_take_rows``: masked index_select."""
    n = table.shape[0]

    def take(i, active):
        ok = active & (i >= 0) & (i < n)
        rows = table.index_select(0, torch.where(ok, i, 0).to(torch.int64))
        return torch.where(ok[:, None], rows, 0.0)

    out = take(idx, torch.ones_like(idx, dtype=torch.bool))
    if idx2 is not None:
        out = out + take(idx2, dup)
    return out


def merge_take_grad(g, n: int, idx, idx2=None, dup=None):
    """d table [N, C] of ``merge_take_rows`` under the output gradient
    ``g`` [M, C]: g rows added at their in-range indices (the others
    park on a spare row past the end, dropped)."""
    def add(d, i, active):
        ok = active & (i >= 0) & (i < n)
        return d.index_add_(0, torch.where(ok, i, n).to(torch.int64), g)

    d = add(g.new_zeros((n + 1, g.shape[1])), idx,
            torch.ones_like(idx, dtype=torch.bool))
    if idx2 is not None:
        d = add(d, idx2, dup)
    return d[:n]


class _MergeTake(torch.autograd.Function):

    @staticmethod
    def forward(ctx, table, idx, idx2, dup):
        ctx.n = table.shape[0]
        ctx.save_for_backward(idx, idx2, dup)
        return _merge_take_forward(table, idx, idx2, dup)

    @staticmethod
    def backward(ctx, g):
        idx, idx2, dup = ctx.saved_tensors
        return merge_take_grad(g, ctx.n, idx, idx2, dup), None, None, None


def merge_take_rows(table, idx, idx2: Optional[torch.Tensor] = None,
                    dup: Optional[torch.Tensor] = None,
                    site: str = '') -> torch.Tensor:
    """``table[idx] (+ table[idx2] where dup)`` -> [M, C] in the table's
    dtype, differentiable in ``table``.

    table [N, C] f32 or bf16 (widened to fp32 exactly and the result
    rounded once to bf16, as the JAX package's bf16 add is); idx, idx2 [M]
    int32; dup [M] bool (with idx2); any width and alignment (the kernel's
    path: ``take_vec4``).
    """
    dev = table.device
    if table.dtype == torch.bfloat16:
        return merge_take_rows(table.float(), idx, idx2, dup,
                               site).to(torch.bfloat16)
    check_tensor('table', table, torch.float32, 2, dev)
    check_tensor('idx', idx, torch.int32, 1, dev)
    m = idx.shape[0]
    if (idx2 is None) != (dup is None):
        raise ValueError('idx2 and dup come together')
    if idx2 is not None:
        check_tensor('idx2', idx2, torch.int32, 1, dev)
        check_tensor('dup', dup, torch.bool, 1, dev)
        if idx2.shape[0] != m or dup.shape[0] != m:
            raise ValueError(f'shape mismatch: idx {tuple(idx.shape)}, idx2 '
                             f'{tuple(idx2.shape)}, dup {tuple(dup.shape)}')
    tag = f'[{site}]' if site else ''
    overflow.record(f'merge_take.win{tag}', 0)
    if table.requires_grad and torch.is_grad_enabled():
        return _MergeTake.apply(table, idx, idx2, dup)
    return _merge_take_forward(table, idx, idx2, dup)


def _merge_take_forward(table, idx, idx2, dup):
    if not kernels.use_kernel(table):
        return merge_take_rows_plain(table, idx, idx2, dup)
    dev = table.device
    m = idx.shape[0]
    n, c = table.shape
    out = torch.empty((m, c), dtype=torch.float32, device=dev)
    fn = kernels.entry_point('merge_take')

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        kernels.check('merge_take', fn(
            table.data_ptr(), n, c, idx.data_ptr(), ptr(idx2), ptr(dup), m,
            out.data_ptr(), int(take_vec4(table, out)), stream))
    kernels.launches['merge_take'] += 1
    return out


def take_vec4(table, out) -> bool:
    """The kernel's path for these tensors: float4 slices of rows where C
    is a multiple of 4 and the table and the output are 16-byte aligned,
    one element per thread otherwise."""
    return (table.shape[1] % 4 == 0 and table.data_ptr() % 16 == 0
            and out.data_ptr() % 16 == 0)
