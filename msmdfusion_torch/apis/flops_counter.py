"""FLOP and parameter counts.

Counterpart of the JAX package's ``apis/flops_counter.py`` (reference
mmdet3d/apis/flops_counter.py:1-27, thop with a custom sparse-conv MAC
hook). The JAX package reads XLA's cost analysis, which counts the
gather-GEMM sparse convs at their true MAC count. Here:

- dense ops are counted as ``torch.utils.flop_counter`` counts them (its
  formulas for ``mm``, ``addmm``, ``bmm``, ``baddbmm``, the convolutions,
  their backward and attention), seen by a ``TorchDispatchMode``;
- the sparse ops are counted once each, at the function level, whatever
  implements them: the CUDA kernels (launched through ``ctypes``, which
  no dispatch mode sees) and their plain PyTorch versions (whose per-tap
  products and dense distances are other work) give the same count. A
  sparse conv (``gather_gemm_conv``, ``match_conv``, and ``conv_dw`` in
  training) adds 2 x hits x Cin x Cout, hits being its plan's valid
  (row, tap) pairs; ``masked_nn`` adds 8 x pairs (3 multiplies and 2 adds
  of the dot product, 1 multiply and 2 adds of the distance), pairs being
  the rows of A times the valid rows of B of the same batch. Nothing they
  call inside is counted again.

``bytes_accessed`` is -1: the value the JAX tool returns where the
analysis has no entry. No byte count is made here.
"""
from __future__ import annotations

import collections
import contextlib
from typing import Any, Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# multiplies and adds of one (query, candidate) pair of masked_nn
NN_FLOP_PER_PAIR = 8


def _hits(rows) -> int:
    return int((rows >= 0).sum())


def _rows_flop(feats, rows, weights, *args, **kwargs) -> int:
    return 2 * _hits(rows) * weights.shape[1] * weights.shape[2]


def _match_flop(feats, in_keys, plan, weights, *args, **kwargs) -> int:
    from ..ops.sparse.matchconv import plan_rows_plain
    rows = plan.rows if plan.rows is not None else \
        plan_rows_plain(in_keys, plan)
    return 2 * _hits(rows) * weights.shape[1] * weights.shape[2]


def _dw_flop(feats, rows, g, *args, **kwargs) -> int:
    return 2 * _hits(rows) * feats.shape[1] * g.shape[1]


def _nn_flop(a, ab, b, bb, b_valid) -> int:
    kept = bb[b_valid]
    pairs = sum(int((ab == g).sum()) * int((kept == g).sum())
                for g in torch.unique(kept).tolist())
    return NN_FLOP_PER_PAIR * pairs


def sparse_sites():
    """{name: (module, attribute, flop of a call)}: where the model looks
    each sparse op up (as ``chip_smoke.wrapper_sites``)."""
    from ..models.middle_encoders import gma_encoder
    from ..ops.sparse import matchconv
    return {'gather_gemm_conv': (matchconv, 'gather_gemm_conv', _rows_flop),
            'match_conv': (matchconv, 'match_conv', _match_flop),
            'conv_dw': (matchconv, 'conv_dw', _dw_flop),
            'masked_nn': (gma_encoder, 'masked_nn', _nn_flop)}


class FlopCount(TorchDispatchMode):
    """Inside the scope: ``by_op`` {op name: FLOP} of the dense ops seen
    by the dispatcher and of the sparse ops (``sparse_sites``), the latter
    counted once a call with the dense counting paused inside them."""

    def __init__(self):
        super().__init__()
        self.by_op: Dict[str, int] = collections.Counter()
        self.sparse_ops = set()
        self._inside = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None and not self._inside:
            self.by_op[str(func._overloadpacket)] += int(
                formula(*args, **kwargs, out_val=out))
        return out

    def _counted(self, name, orig, flop):
        def wrapper(*args, **kwargs):
            if self._inside:
                return orig(*args, **kwargs)
            self._inside += 1
            try:
                with torch.no_grad():
                    self.by_op[name] += flop(*args, **kwargs)
                return orig(*args, **kwargs)
            finally:
                self._inside -= 1
        return wrapper

    def __enter__(self):
        self._stack = contextlib.ExitStack()
        for name, (module, attr, flop) in sparse_sites().items():
            orig = getattr(module, attr)
            setattr(module, attr, self._counted(name, orig, flop))
            self._stack.callback(setattr, module, attr, orig)
            self.sparse_ops.add(name)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._stack.close()

    @property
    def total(self) -> int:
        return sum(self.by_op.values())

    @property
    def sparse(self) -> int:
        return sum(v for k, v in self.by_op.items() if k in self.sparse_ops)


def count_flops(fn: Callable, *example_args) -> Dict[str, Any]:
    """The FLOP of one call of ``fn(*example_args)`` (its autograd
    backward too where ``fn`` runs one): dict(flops, bytes_accessed: -1,
    gflops) as the JAX tool returns, with ``sparse_flops`` (the sparse
    ops' part) and ``by_op``."""
    with FlopCount() as counter:
        fn(*example_args)
    return {'flops': float(counter.total), 'bytes_accessed': -1.0,
            'gflops': counter.total / 1e9,
            'sparse_flops': float(counter.sparse),
            'by_op': dict(counter.by_op)}


def count_params(model: torch.nn.Module) -> int:
    """The model's parameters (not its buffers): the JAX
    ``count_params(params)`` of the same config (the GMA's
    ``dummy_embedding_{i}`` is a parameter on both sides)."""
    return sum(p.numel() for p in model.parameters())
